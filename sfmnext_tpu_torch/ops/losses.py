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


def tiebreak_noise(generator: torch.Generator, shape) -> torch.Tensor:
    """The identity losses' tie-break noise, 1e-5 * N(0,1) of shape
    [1, *shape[1:]] on the generator's device (trainer.py:516-517; the JAX
    package shares one draw across the batch, losses.py:62-82)."""
    return 1e-5 * torch.randn((1, *shape[1:]), generator=generator, device=generator.device)


def min_reprojection_loss(reproj_losses, identity_losses=None, generator=None,
                          avg_reprojection: bool = False):
    """Monodepth2's min over frames with automasking.

    Args:
      reproj_losses: list of [B,H,W,F_i] per-source photometric errors.
      identity_losses: optional list of [B,H,W,F_i] errors of the unwarped
        sources; when given, automasking is on.
      generator: a ``torch.Generator`` on the losses' device to draw the
        identities' tie-break noise from (``tiebreak_noise``), in their
        shape after ``avg_reprojection`` averages them (losses.py:111-115);
        None adds none.
      avg_reprojection: average the reprojection and the identity errors
        over the sources before the min.
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
    if generator is not None:
        ident = ident + tiebreak_noise(generator, ident.shape)
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


def silog_loss(pred, target, mask=None, variance_focus: float = 0.85):
    """Scale-invariant log loss 10*sqrt(var(g) + 0.15*mean(g)^2) of
    g = log(pred) - log(target) (reference finetune/loss.py:24-42).

    With a boolean ``mask`` the statistics are the masked ones, weighted by
    the mask so every shape stays static, as the JAX package computes them;
    masked-out entries take log(1) = 0."""
    if mask is not None:
        m = mask.to(pred.dtype)
        n = m.sum() + 1e-7
        one = torch.ones((), dtype=pred.dtype, device=pred.device)
        g = (torch.log(torch.where(mask, pred, one)) - torch.log(torch.where(mask, target, one))) * m
        mean_g = g.sum() / n
        var_g = (g * g).sum() / n - mean_g * mean_g
    else:
        g = torch.log(pred) - torch.log(target)
        mean_g = g.mean()
        var_g = g.var(unbiased=False)
    return 10.0 * torch.sqrt(var_g + (1.0 - variance_focus) * mean_g * mean_g)


def l2_loss(pred, target, mask=None):
    """Mean squared error, masked when ``mask`` is given (reference
    finetune/loss.py:7-21)."""
    if mask is not None:
        m = mask.to(pred.dtype)
        return (((pred - target) ** 2) * m).sum() / m.sum().clamp(min=1.0)
    return ((pred - target) ** 2).mean()


def bins_chamfer_loss(bin_edges, target_depth, valid_mask=None):
    """Symmetric chamfer distance between the bin centres [B,D] of
    ``bin_edges`` [B,D+1] and the valid target depths of each sample
    (reference finetune/loss.py:45-63, AdaBins; the reference's pytorch3d
    call written out, as the JAX package does). Without ``valid_mask`` a
    depth is valid at >= 1e-3."""
    centers = 0.5 * (bin_edges[:, 1:] + bin_edges[:, :-1])
    b = centers.shape[0]
    tgt = target_depth.reshape(b, -1)
    valid = tgt >= 1e-3 if valid_mask is None else valid_mask.reshape(b, -1)
    m = valid.to(centers.dtype)
    d2 = (centers[:, :, None] - tgt[:, None, :]) ** 2  # [B,D,N]
    big = torch.full((), 1e9, dtype=d2.dtype, device=d2.device)
    c2t = torch.where(valid[:, None, :], d2, big).amin(dim=2).mean(dim=1)
    t2c = (d2.amin(dim=1) * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
    return (c2t + t2c).mean()
