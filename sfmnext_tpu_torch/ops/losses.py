"""Training losses. Counterpart of ``sfmnext_tpu/ops/losses.py``: the
photometric stack (0.85 SSIM + 0.15 L1, or L1 alone under ``--no_ssim``),
the min-reprojection combine with automasking, and edge-aware smoothness
(reference trainer.py:441-549, layers.py:267-280).

These are the plain ops. The training step's fused route (SSIM stacks,
identity stack and min in the Hopper kernels) is ``ops/ssim_kernel.py``.
Layouts are the JAX package's NHWC.
"""

from __future__ import annotations

import torch

from sfmnext_tpu_torch.ops.image import ssim, ssim_multi, ssim_target_stats


def reprojection_loss(pred, target, ssim_weight: float = 0.85, use_ssim: bool = True):
    """Per-pixel photometric error [B,H,W,1] (reference trainer.py:441-453)."""
    l1 = (target - pred).abs().mean(dim=-1, keepdim=True)
    if not use_ssim:
        return l1
    ssim_err = ssim(pred, target).mean(dim=-1, keepdim=True)
    return ssim_weight * ssim_err + (1.0 - ssim_weight) * l1


def reprojection_losses_stacked(preds, target, ssim_weight: float = 0.85,
                                use_ssim: bool = True, target_stats=None):
    """Per-frame photometric error [B,H,W,N] of N predictions [B,H,W,3]
    against one target, the math of :func:`reprojection_loss` per frame.

    The L1 term is computed in the inputs' dtype (the channel mean
    accumulated in float32); the SSIM term takes the products in the inputs'
    dtype and pools in float32. All N predictions share one channel-stacked
    SSIM pass and the target statistics (``target_stats``:
    ``ssim_target_stats(target)``, or None to compute).
    """
    l1 = torch.stack([(target - p).abs().mean(dim=-1) for p in preds], dim=-1)
    if not use_ssim:
        return l1
    if target_stats is None:
        target_stats = ssim_target_stats(target)
    stacked = torch.cat(list(preds), dim=-1)  # [B,H,W,3N]
    b, h, w, _ = stacked.shape
    ssim_err = ssim_multi(stacked, target_stats).reshape(b, h, w, len(preds), 3).mean(dim=-1)
    return ssim_weight * ssim_err + (1.0 - ssim_weight) * l1


def min_reprojection_loss(reproj_losses, identity_losses=None, noise=None,
                          avg_reprojection: bool = False):
    """Monodepth2's min over frames with automasking.

    Args:
      reproj_losses: list of [B,H,W,F_i] per-source photometric errors.
      identity_losses: optional list of [B,H,W,F_i] errors of the unwarped
        sources; when given, automasking is on.
      noise: optional tie-break noise added to the identity losses, of
        their shape or broadcastable to it (the JAX package draws
        1e-5 * N(0,1) of shape [1,H,W,F], trainer.py:516-517); None adds
        none.
    Returns:
      (to_optimise [B,H,W], automask [B,H,W] float or None; 1 where a
      reprojection won).
    """
    reproj = torch.cat(reproj_losses, dim=-1)
    if avg_reprojection:
        reproj = reproj.mean(dim=-1, keepdim=True)
    if identity_losses is None:
        return reproj.amin(dim=-1), None
    ident = torch.cat(identity_losses, dim=-1)
    if avg_reprojection:
        ident = ident.mean(dim=-1, keepdim=True)
    if noise is not None:
        ident = ident + noise
    combined = torch.cat([ident, reproj], dim=-1)
    to_optimise, idxs = combined.min(dim=-1)
    automask = (idxs >= ident.shape[-1]).to(reproj.dtype)
    return to_optimise, automask


def edge_aware_smoothness(disp, img, compute_dtype=None):
    """Edge-aware first-order smoothness (a scalar) of disp [B,H,W,1]
    guided by img [B,H,W,3]; the gradient and exp math in
    ``compute_dtype`` when given, the means in float32."""
    if compute_dtype is not None:
        disp, img = disp.to(compute_dtype), img.to(compute_dtype)
    grad_disp_x = (disp[:, :, :-1] - disp[:, :, 1:]).abs()
    grad_disp_y = (disp[:, :-1] - disp[:, 1:]).abs()
    grad_img_x = (img[:, :, :-1] - img[:, :, 1:]).abs().mean(dim=-1, keepdim=True)
    grad_img_y = (img[:, :-1] - img[:, 1:]).abs().mean(dim=-1, keepdim=True)
    sx = (grad_disp_x * torch.exp(-grad_img_x)).float()
    sy = (grad_disp_y * torch.exp(-grad_img_y)).float()
    return sx.mean() + sy.mean()
