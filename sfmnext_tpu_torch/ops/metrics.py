"""Depth evaluation metrics and eval-protocol helpers. Counterpart of
``sfmnext_tpu/ops/metrics.py``.

Behavioral reference:
  - compute_depth_errors  layers.py:282-300 / evaluate_depth_config.py:30-48
  - eigen crop + median scaling  evaluate_depth_config.py:225-261
  - flip post-process blend  evaluate_depth_config.py:51-59
  - garg crop for train-time val  trainer.py:566-567
  - finetune 9-metric dict (adds silog, log10)  finetune/evaluate_metric_depth.py:19-39

The per-image metrics take numpy arrays (GT sizes vary per image) or
torch tensors; the masked batch metrics of train-time validation take
tensors on any device and stay there.
"""

from __future__ import annotations

import numpy as np
import torch


def compute_depth_errors(gt, pred):
    """7-tuple (abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3) on flat arrays,
    numpy or torch. Reference layers.py:282-300."""
    xp = torch if isinstance(gt, torch.Tensor) else np
    thresh = xp.maximum(gt / pred, pred / gt)
    a1 = _fraction(thresh < 1.25, gt.dtype)
    a2 = _fraction(thresh < 1.25 ** 2, gt.dtype)
    a3 = _fraction(thresh < 1.25 ** 3, gt.dtype)
    rmse = xp.sqrt(((gt - pred) ** 2).mean())
    rmse_log = xp.sqrt(((xp.log(gt) - xp.log(pred)) ** 2).mean())
    abs_rel = (xp.abs(gt - pred) / gt).mean()
    sq_rel = ((gt - pred) ** 2 / gt).mean()
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3


def _fraction(mask, dtype):
    """The share of True in a numpy or torch mask, in ``dtype``."""
    return mask.astype(dtype).mean() if isinstance(mask, np.ndarray) else mask.to(dtype).mean()


def compute_depth_errors_masked(gt, pred, mask):
    """Mask-weighted batch metrics (train-time validation).

    Args:
      gt, pred: [N] or [B,H,W(,1)] depth tensors (same shape).
      mask: bool, the same shape; the metrics average over it only.
    Returns:
      dict of the 7 scalar metrics (0-d float32 tensors) under the
      reference's ``de/*`` and ``da/*`` names.
    """
    m = mask.float()
    n = m.sum() + 1e-7
    gt_s = torch.where(mask, gt, torch.ones_like(gt))
    pred_s = torch.where(mask, pred, torch.ones_like(pred))
    thresh = torch.maximum(gt_s / pred_s, pred_s / gt_s)

    def mmean(x):
        return (x * m).sum() / n

    diff = gt_s - pred_s
    logdiff = torch.log(gt_s) - torch.log(pred_s)
    return {
        "de/abs_rel": mmean(diff.abs() / gt_s),
        "de/sq_rel": mmean(diff * diff / gt_s),
        "de/rms": torch.sqrt(mmean(diff * diff)),
        "de/log_rms": torch.sqrt(mmean(logdiff * logdiff)),
        "da/a1": mmean((thresh < 1.25).float()),
        "da/a2": mmean((thresh < 1.25 ** 2).float()),
        "da/a3": mmean((thresh < 1.25 ** 3).float()),
    }


def compute_metric_depth_errors(gt, pred):
    """9-metric dict of the metric-finetune eval, numpy.

    Reference finetune/evaluate_metric_depth.py:19-39 (adds silog, log10).
    """
    abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3 = compute_depth_errors(gt, pred)
    err = np.log(pred) - np.log(gt)
    silog = np.sqrt(np.mean(err ** 2) - np.mean(err) ** 2) * 100
    log10 = np.mean(np.abs(np.log10(gt) - np.log10(pred)))
    return {
        "a1": a1, "a2": a2, "a3": a3,
        "abs_rel": abs_rel, "sq_rel": sq_rel, "rmse": rmse,
        "rmse_log": rmse_log, "silog": silog, "log_10": log10,
    }


def eigen_crop_mask(gt_height: int, gt_width: int) -> np.ndarray:
    """Boolean [H,W] eigen-crop mask. Reference evaluate_depth_config.py:237-241."""
    crop = np.array(
        [0.40810811 * gt_height, 0.99189189 * gt_height,
         0.03594771 * gt_width, 0.96405229 * gt_width]
    ).astype(np.int32)
    mask = np.zeros((gt_height, gt_width), dtype=bool)
    mask[crop[0]:crop[1], crop[2]:crop[3]] = True
    return mask


def garg_crop_mask(gt_height: int = 375, gt_width: int = 1242) -> np.ndarray:
    """Garg crop used in train-time val. Reference trainer.py:566-567."""
    mask = np.zeros((gt_height, gt_width), dtype=bool)
    mask[153:371, 44:1197] = True
    return mask


def flip_postprocess(disp, disp_flipped):
    """Blend normal / horizontally-flipped predictions, numpy or torch.

    Reference evaluate_depth_config.py:51-59 (batch_post_process_disparity):
    a per-column ramp fades between the two predictions.

    Args:
      disp: [B,H,W] prediction on the original image.
      disp_flipped: [B,H,W] prediction on the flipped image (already
        re-flipped back to original orientation).
    """
    b, h, w = disp.shape
    mean = 0.5 * (disp + disp_flipped)
    if isinstance(disp, torch.Tensor):
        xs = torch.linspace(0, 1, w, dtype=disp.dtype, device=disp.device)
        l_mask = (1.0 - torch.clamp(20 * (xs - 0.05), 0, 1)).expand(b, h, w)
        r_mask = l_mask.flip(-1)
    else:
        xs = np.linspace(0, 1, w).astype(disp.dtype)
        l_mask = np.broadcast_to(1.0 - np.clip(20 * (xs - 0.05), 0, 1), (b, h, w))
        r_mask = l_mask[:, :, ::-1]
    return r_mask * disp + l_mask * disp_flipped + (1.0 - l_mask - r_mask) * mean


def median_scale(gt, pred):
    """Per-image median scaling ratio. Reference evaluate_depth_config.py:253-256."""
    return np.median(gt) / np.median(pred)
