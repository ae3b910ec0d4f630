"""Image ops. Counterpart of ``sfmnext_tpu/ops/image.py``: the resize and
the SSIM maps of the photometric loss.

The JAX package expresses the resize as interpolation-matrix matmuls and
the SSIM box filter as band matmuls, both TPU layout workarounds; here
they are ``F.interpolate`` and a reflect pad plus ``F.avg_pool2d``, the
semantics the JAX versions were written to match.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SSIM_C1 = 0.01 ** 2
SSIM_C2 = 0.03 ** 2


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = False):
    """Bilinear resize of NCHW ``x`` to ``out_hw`` (no antialiasing).

    Unlike the JAX counterpart (NHWC) this takes the port's internal NCHW
    layout. ``align_corners=True`` is DecoderBN's upsample, ``False`` the
    final depth resize.
    """
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(
        x, size=tuple(out_hw), mode="bilinear", align_corners=align_corners,
        antialias=False,
    )


def box_filter_reflect(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k average of [B,H,W,C] with reflection padding (the edge is not
    repeated), same-size float32 output; H and W must exceed k // 2."""
    p = k // 2
    y = F.pad(x.float().permute(0, 3, 1, 2), (p, p, p, p), mode="reflect")
    return F.avg_pool2d(y, k, stride=1).permute(0, 2, 3, 1)


def ssim_target_stats(target: torch.Tensor, k: int = 7):
    """The target-side window statistics (target, mu_t, sigma_t), computed
    once and shared by every prediction compared with the same target."""
    mu_t = box_filter_reflect(target, k)
    sigma_t = box_filter_reflect(target * target, k) - mu_t * mu_t
    return target, mu_t, sigma_t


def _ssim_distance(mu_p, sigma_p, sigma_pt, mu_t, sigma_t, c1, c2):
    num = (2 * mu_p * mu_t + c1) * (2 * sigma_pt + c2)
    den = (mu_p * mu_p + mu_t * mu_t + c1) * (sigma_p + sigma_t + c2)
    return torch.clamp((1.0 - num / den) / 2.0, 0.0, 1.0)


def ssim_multi(preds: torch.Tensor, target_stats, k: int = 7,
               c1: float = SSIM_C1, c2: float = SSIM_C2) -> torch.Tensor:
    """SSIM distance of N channel-stacked predictions [B,H,W,3N] against
    one target: [B,H,W,3N] float32, the math of :func:`ssim` per group."""
    tgt, mu_t, sigma_t = target_stats
    n = preds.shape[-1] // tgt.shape[-1]
    mu_p = box_filter_reflect(preds, k)
    sigma_p = box_filter_reflect(preds * preds, k) - mu_p * mu_p
    mu_t_n = mu_t.repeat(1, 1, 1, n)
    sigma_pt = box_filter_reflect(preds * tgt.repeat(1, 1, 1, n), k) - mu_p * mu_t_n
    return _ssim_distance(mu_p, sigma_p, sigma_pt, mu_t_n, sigma_t.repeat(1, 1, 1, n), c1, c2)


def ssim(x: torch.Tensor, y: torch.Tensor, k: int = 7, c1: float = SSIM_C1,
         c2: float = SSIM_C2) -> torch.Tensor:
    """SSIM distance map clamp((1 - SSIM) / 2, 0, 1) of [B,H,W,C] images
    (reference layers.py:13-46, k=7 with reflection padding)."""
    mu_x = box_filter_reflect(x, k)
    mu_y = box_filter_reflect(y, k)
    sigma_x = box_filter_reflect(x * x, k) - mu_x * mu_x
    sigma_y = box_filter_reflect(y * y, k) - mu_y * mu_y
    sigma_xy = box_filter_reflect(x * y, k) - mu_x * mu_y
    return _ssim_distance(mu_x, sigma_x, sigma_xy, mu_y, sigma_y, c1, c2)
