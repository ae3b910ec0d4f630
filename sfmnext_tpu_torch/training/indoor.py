"""The indoor self-supervised forward and loss (NYUv2, MannequinChallenge).
Counterpart of ``sfmnext_tpu/training/indoor.py`` (reference
trainer_indoor.py):

  * ``rectify_references`` (:877-924): RectifyNet pre-warps each reference
    frame to cancel camera shake, with the rotation-consistency loss
    |rot3 - sg(rot1)| and the triplet hinge relu(|rot2| - |rot1| + 0.05);
  * a depth pass per reference frame (:371-377) and the warp of its depth
    into the target view (:506-598);
  * ``compute_losses_with_occ`` (:615-719): the min-reprojection loss
    weighted by the occlusion mask 1 - sqrt(1 - (d-1)^2), d = |com - proj|
    / (com + proj), plus an L1 depth-consistency term (``reg_wt``);
  * ``photo_and_geometry_loss_imp`` (:926-1012): masked photometric and
    geometric losses with the frame chosen by the raw colour difference.

The batch is ``training/pipeline.py``'s plus ``K3x3`` [B,3,3] (or ``K``'s
corner). The networks run under autocast in the compute dtype, geometry,
warps and losses outside it in float32. With ``opt.use_pallas`` every
warp goes through ``warp_kernel.warp_sample`` (the Hopper kernels on the
card, with the image gradient where the sampled rectified frame or
reference depth carries one), in the train step and in the eval step
alike, as in ``training/pipeline.py``; without it, through the plain
samples. BatchNorm running statistics update in place in the JAX
order: the encoder's over the target pass, then each reference pass; the
RectifyNet's over its six calls.
"""

from __future__ import annotations

import torch

from sfmnext_tpu_torch.ops import geometry, losses as L
from sfmnext_tpu_torch.ops.image import resize_bilinear, ssim
from sfmnext_tpu_torch.ops.warp import grid_sample, inverse_rotation_warp
from sfmnext_tpu_torch.training.pipeline import _nchw, autocast, predict_poses


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def rectify_references(models, tgt, refs, K3, use_kernel: bool = False):
    """RectifyNet pre-warp of each reference [B,H,W,3] towards the target
    (ref :877-924). Returns (rectified refs, loss_rc, loss_rt)."""

    def rect(a, b):
        with autocast(models, a.device):
            return models.rectify(_nchw(a), _nchw(b))

    warped, rc_terms, rt_terms = [], [], []
    for ref in refs:
        rot1 = rect(tgt, ref)
        ref_w = inverse_rotation_warp(ref, rot1, K3, use_kernel=use_kernel)
        rot2 = rect(tgt, ref_w)
        rot3 = rect(ref_w.detach(), ref)
        rc_terms.append((rot3 - rot1.detach()).abs().mean())
        rt_terms.append((rot2.abs() - rot1.abs() + 0.05).clamp(min=0.0).mean())
        warped.append(ref_w)
    return warped, torch.stack(rc_terms).mean(), torch.stack(rt_terms).mean()


def _depth_forward(models, img):
    """Depth at half resolution [B,1,H/2,W/2] float32 of img [B,H,W,3]."""
    with autocast(models, img.device):
        return models.depth(models.encoder(_nchw(img)))["disp0"]


def forward_indoor(models, batch, opt, generator=None):
    """Depth, rectification, poses, warps and the indoor losses of one batch.

    Args, returns: as ``pipeline.forward``; ``generator`` draws the
    identity losses' tie-break noise, [1,H,W,n_sources] (or [1,H,W,1]
    under ``--avg_reprojection`` with the occlusion loss).

    Poses come from the PoseCNN on frame pairs only. The JAX package's
    indoor step calls ``predict_poses`` without ``opt`` or BatchNorm
    statistics, and with any other pose net or ``--pose_model_input all``
    it fails (the separate ResNet-18 finds no BatchNorm statistics, the
    shared PoseDecoder and the all-frames PoseCNN receive frame pairs of
    the wrong width); this step raises there. A ``--predictive_mask`` net
    is built and, as in the JAX indoor step, not used.
    """
    if opt.pose_model_type != "posecnn" or opt.num_pose_frames != 2:
        raise NotImplementedError(
            f"the indoor step with --pose_model_type {opt.pose_model_type} --pose_model_input "
            f"{opt.pose_model_input}: the JAX package's forward_indoor fails there too "
            "(ROADMAP.md §3); it trains with the PoseCNN on frame pairs only")
    frame_ids = [f for f in opt.all_frame_ids if f != "s"]
    color = batch["color"]
    b, _, h, w, _ = color.shape

    # 1. target depth from the augmented target frame
    depth_half = _depth_forward(models, batch["color_aug"][:, 0])
    depth = _nhwc(resize_bilinear(depth_half, (h, w), align_corners=False))
    outputs = {"depth": depth, "depth_half": _nhwc(depth_half)}

    refs = [color[:, i].contiguous() for i in range(1, len(frame_ids))]
    use_kernel = opt.use_pallas

    # 2. rectification
    loss_rc = loss_rt = None
    if opt.use_rectify_net and models.rectify is not None:
        K3 = batch["K3x3"] if "K3x3" in batch else batch["K"][:, :3, :3]
        refs, loss_rc, loss_rt = rectify_references(models, color[:, 0], refs, K3, use_kernel)

    # 3. poses from the raw target and the (rectified) references, not
    # color_aug (trainer_indoor.py:439-444)
    poses = predict_poses(models, batch, frame_ids, opt,
                          pose_frames=torch.stack([color[:, 0], *refs], dim=1))
    mean_inv_depth = (1.0 / depth).mean(dim=(1, 2, 3))
    need_geo = opt.use_photo_geo_loss or opt.use_improved_mini_reproj_loss

    # 4. a depth pass per (rectified) reference frame (ref :371-377)
    depth_refs = [_nhwc(resize_bilinear(_depth_forward(models, ref), (h, w), align_corners=False))
                  for ref in refs] if need_geo else []

    # 5. warps of the references and their depths into the target view
    K, inv_K = batch["K"], batch["inv_K"]
    target = color[:, 0].contiguous()
    warped_colors, pred_deps, com_deps = [], [], []
    for i, f_i in enumerate(frame_ids[1:]):
        axisangle, translation, invert = poses[f_i]
        if opt.pose_model_type == "posecnn" and not opt.use_stereo:
            translation = translation * mean_inv_depth[:, None]
        T = geometry.transformation_from_parameters(axisangle, translation, invert=invert)
        cam_points = geometry.backproject_depth(depth, inv_K)
        pix = geometry.project_3d(cam_points, K, T, h, w)
        warped_colors.append(grid_sample(refs[i], pix, "border", True, use_kernel))
        if need_geo:
            pred_deps.append(grid_sample(depth_refs[i], pix, "border", True, use_kernel))
            com_deps.append(geometry.project_depth(cam_points, K, T, h, w))
        outputs[f"warped_{f_i}"] = warped_colors[-1]

    # the loss dispatch of trainer_indoor.py:380-416: inside the photo_geo
    # branch, --use_mini_reprojection_loss falls back to monodepth2's loss
    metrics = {}
    raw_refs = [color[:, 1 + i] for i in range(len(refs))]
    if opt.use_photo_geo_loss and not opt.use_mini_reprojection_loss:
        photo, geo = photo_and_geometry_loss_imp(
            target, raw_refs, warped_colors, depth_refs, pred_deps, com_deps, opt)
        smooth = _norm_smooth(depth, target)
        total = (opt.loss_photo_weight * photo + opt.loss_geo_weight * geo
                 + opt.disparity_smoothness * smooth)
        metrics.update({"loss/photo": photo, "loss/geo": geo, "loss/smooth": smooth})
    elif opt.use_improved_mini_reproj_loss and not opt.use_photo_geo_loss:
        total, parts = compute_losses_with_occ(
            target, raw_refs, warped_colors, pred_deps, depth, depth_half, generator, opt)
        metrics.update(parts)
    else:  # monodepth2's min-reprojection
        reproj = [L.reprojection_loss(wc, target, opt.ssim_weight, not opt.no_ssim)
                  for wc in warped_colors]
        ident = None if opt.disable_automasking else _identity_losses(raw_refs, target, opt)
        to_optimise, _ = L.min_reprojection_loss(reproj, ident, generator)
        smooth = _norm_smooth(depth, target)
        total = to_optimise.mean() + opt.disparity_smoothness * smooth
        metrics["loss/smooth"] = smooth

    if loss_rc is not None:
        total = total + opt.loss_rc_weight * loss_rc + opt.loss_rt_weight * loss_rt
        metrics.update({"loss/rc": loss_rc, "loss/rt": loss_rt})
    metrics["loss"] = total
    return total, {"outputs": outputs, "metrics": metrics}


def _norm_smooth(depth, color):
    return L.edge_aware_smoothness(depth / (depth.mean(dim=(1, 2, 3), keepdim=True) + 1e-7), color)


def _identity_losses(raw_refs, target, opt):
    """The unwarped references' photometric errors (data: no gradient)."""
    with torch.no_grad():
        return [L.reprojection_loss(ref, target, opt.ssim_weight, not opt.no_ssim)
                for ref in raw_refs]


def compute_losses_with_occ(target, raw_refs, warped_colors, pred_deps, depth, depth_half,
                            generator, opt):
    """Occlusion-weighted min-reprojection (ref :615-719). depth [B,H,W,1],
    depth_half [B,1,H/2,W/2]. Returns (total, {term: value})."""
    reproj, l1_reg = [], []
    for pred, projected in zip(warped_colors, pred_deps):
        valid = (pred.abs().mean(dim=-1, keepdim=True) > 1e-3).to(pred.dtype)
        err = L.reprojection_loss(pred, target, opt.ssim_weight, not opt.no_ssim)
        # the target depth is the "computed" depth here (ref :642)
        d = (depth - projected).abs() / (depth + projected)
        l1_reg.append(d * valid)
        # occlusion weight 1 - sqrt(1 - (d-1)^2), d in [0, 1] (ref :649), with
        # 1 - (d-1)^2 as d (2 - d): the same number without the cancellation
        # that costs a small d most of its float32 digits
        wmask = (1.0 - torch.sqrt(torch.clamp(d * (2.0 - d), 0.0, 1.0))).detach()
        reproj.append(err * wmask * valid)
    ident = None if opt.disable_automasking else _identity_losses(raw_refs, target, opt)
    to_optimise, _ = L.min_reprojection_loss(reproj, ident, generator,
                                             avg_reprojection=opt.avg_reprojection)
    l1_loss = torch.cat(l1_reg, dim=-1).mean()

    # smoothness at the decoder's (half) resolution with the colour resized
    # to it (ref :701-712)
    color_small = _nhwc(resize_bilinear(_nchw(target), depth_half.shape[-2:],
                                        align_corners=False))
    norm_d = depth_half / (depth_half.mean(dim=(1, 2, 3), keepdim=True) + 1e-7)
    smooth = L.edge_aware_smoothness(_nhwc(norm_d), color_small)
    reprojection = to_optimise.mean()
    total = reprojection + opt.reg_wt * l1_loss + opt.disparity_smoothness * smooth
    return total, {"loss/reprojection": reprojection, "loss/l1_reg": l1_loss,
                   "loss/smooth": smooth}


def photo_and_geometry_loss_imp(target, raw_refs, warped_colors, depth_refs, pred_deps,
                                com_deps, opt):
    """Masked photometric and geometric losses with the frame chosen per
    pixel by the raw colour difference (ref :926-1012). Returns (photo, geo)."""
    diff_imgs, diff_colors, valid_masks, geo_diffs = [], [], [], []
    for ref, warped, d_ref, proj, com in zip(raw_refs, warped_colors, depth_refs, pred_deps,
                                             com_deps):
        d = (com - proj).abs() / (com + proj)
        geo = (com - d_ref).abs().mean(dim=-1, keepdim=True)
        valid = ((warped.abs().mean(dim=-1, keepdim=True) > 1e-3)
                 & (target.abs().mean(dim=-1, keepdim=True) > 1e-3)).to(target.dtype)
        diff_color = (target - warped).abs().mean(dim=-1, keepdim=True)
        ident_err = (target - ref).abs().mean(dim=-1, keepdim=True)
        valid = valid * (diff_color < ident_err).to(target.dtype)
        di = (target - warped).abs().clamp(0.0, 1.0)
        di = (opt.l1_weight * di + opt.ssim_weight * ssim(target, warped)).mean(dim=-1, keepdim=True)
        weight = (1.0 - d).detach()
        diff_imgs.append(di * weight)
        geo_diffs.append(geo * weight)
        diff_colors.append(diff_color)
        valid_masks.append(valid)

    idx = torch.cat(diff_colors, dim=-1).argmin(dim=-1, keepdim=True)

    def take(parts):
        return torch.gather(torch.cat(parts, dim=-1), -1, idx)

    diff_img, valid, geo = take(diff_imgs), take(valid_masks), take(geo_diffs)

    def mean_on_mask(x, m):
        # zero when the mask is too small (ref layers.py:374-380)
        s = m.sum()
        return torch.where(s > 100, (x * m).sum() / s.clamp(min=1.0), torch.zeros_like(s))

    return mean_on_mask(diff_img, valid), mean_on_mask(geo, valid)
