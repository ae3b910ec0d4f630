"""The self-supervised forward and loss. Counterpart of
``sfmnext_tpu/training/pipeline.py`` (reference trainer.py:266-549):
``predict_poses`` in its PoseCNN batched-pairs branch and ``forward``
(photometric stack with SSIM or, under ``--no_ssim``, L1 alone;
min-reprojection with automasking; edge-aware smoothness).

The batch is the JAX package's: ``color`` and ``color_aug`` [B,F,H,W,3]
with F following ``opt.all_frame_ids``, ``K`` and ``inv_K`` [B,4,4], all
on the models' device. The networks run under autocast in the compute
dtype (their parameters stay float32, as flax keeps its params); depth,
geometry, warps and losses run outside it, the geometry and warps in
float32. With ``opt.use_pallas`` the SQL decoder, the warps and the SSIM
loss go through the Hopper kernels (their plain versions for CPU
tensors), as the JAX package routes them on a TPU; without it, through
the plain ops.
"""

from __future__ import annotations

import torch

from sfmnext_tpu_torch.ops import geometry, losses as L, ssim_kernel
from sfmnext_tpu_torch.ops.image import resize_bilinear
from sfmnext_tpu_torch.ops.warp import warp_frame


def autocast(models, device: torch.device):
    """The networks' compute dtype as autocast (off for float32)."""
    bf16 = models.compute_dtype == torch.bfloat16
    return torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def predict_poses(models, batch, frame_ids, opt):
    """PoseCNN over the temporally ordered (earlier, later) pairs of the
    target with each source, all pairs in one batched forward.

    Returns {frame_id: (axisangle [B,3], translation [B,3], invert)}; a
    past frame's transform is inverted (trainer.py:324-331).
    """
    if opt.pose_model_type != "posecnn" or opt.num_pose_frames != 2:
        raise NotImplementedError(
            "the port predicts poses with the PoseCNN on frame pairs only")
    color_aug = batch["color_aug"]
    srcs = [(idx, f_i) for idx, f_i in enumerate(frame_ids[1:], start=1) if f_i != "s"]
    pairs = [
        torch.cat([color_aug[:, idx], color_aug[:, 0]] if f_i < 0
                  else [color_aug[:, 0], color_aug[:, idx]], dim=-1)
        for idx, f_i in srcs
    ]
    with autocast(models, color_aug.device):
        axisangle, translation = models.pose(_nchw(torch.cat(pairs, dim=0)))
    b = color_aug.shape[0]
    return {
        f_i: (axisangle[j * b:(j + 1) * b, 0, 0], translation[j * b:(j + 1) * b, 0, 0], f_i < 0)
        for j, (_, f_i) in enumerate(srcs)
    }


def forward(models, batch, opt, noise=None):
    """Depth, poses, warps and losses of one batch.

    Args:
      models: a training ``ModelBundle``.
      batch: the tensors described in the module docstring.
      opt: Options.
      noise: tie-break noise for the identity losses, [1,H,W,n_sources]
        (the JAX package draws 1e-5 * N(0,1) there), or None.
    Returns:
      (total loss, {"outputs", "metrics"}); BatchNorm running statistics
      update in place.
    """
    if opt.predictive_mask or opt.use_stereo:
        raise NotImplementedError("--predictive_mask and --use_stereo are not ported yet")
    frame_ids = opt.all_frame_ids
    color = batch["color"]
    dev = color.device
    b, _, h, w, _ = color.shape

    # 1. depth from the augmented target frame (trainer.py:286-288)
    with autocast(models, dev):
        dec = models.depth(models.encoder(_nchw(batch["color_aug"][:, 0])))
    depth_half = dec["disp0"]  # [B,1,H/2,W/2] float32: depth, a reference quirk
    depth = resize_bilinear(depth_half, (h, w), align_corners=False).permute(0, 2, 3, 1)
    outputs = {"depth": depth, "bin_centers": dec["bin_centers"]}

    # 2. poses; PoseCNN translations scale by the mean inverse depth
    # (trainer.py:412-421)
    poses = predict_poses(models, batch, frame_ids, opt)
    mean_inv_depth = (1.0 / depth).mean(dim=(1, 2, 3))

    # 3. warp every source frame into the target view
    K, inv_K = batch["K"], batch["inv_K"]
    target = color[:, 0].contiguous()  # the loss kernels' [B,H,W,3] layout
    loss_dtype = opt.compute_dtype if opt.loss_dtype == "auto" else opt.loss_dtype
    ldt = torch.bfloat16 if loss_dtype == "bfloat16" else torch.float32
    warped_srcs, ident_srcs = [], []
    for idx, f_i in enumerate(frame_ids[1:], start=1):
        axisangle, translation, invert = poses[f_i]
        translation = translation * mean_inv_depth[:, None]
        T = geometry.transformation_from_parameters(axisangle, translation, invert=invert)
        src = color[:, idx].contiguous()  # the warp kernel's [B,H,W,3] layout
        warped, _ = warp_frame(src, depth, inv_K, K, T, use_kernel=opt.use_pallas)
        outputs[f"warped_{f_i}"] = warped
        warped_srcs.append(warped)
        ident_srcs.append(src)

    # 4. photometric maps (inputs in the loss dtype, maps in float32), then
    # the min over frames with automasking (trainer.py:441-530)
    use_ssim = not opt.no_ssim
    fused = use_ssim and opt.use_pallas
    automasking = not opt.disable_automasking
    if fused and automasking and opt.avg_reprojection:
        raise NotImplementedError(
            "--avg_reprojection needs the identity stack without the fused min, TPU "
            "kernel #8 (ssim_kernel.py _call_fwd_only), which is not ported yet")
    if fused and automasking:
        # the SSIM stacks, the identity stack, the noise and the min in the
        # kernels; the identities' maps never reach device memory
        to_optimise, automask = ssim_kernel.reprojection_min(
            warped_srcs, ident_srcs, target, noise, opt.ssim_weight, ldt)
    else:
        ident = None
        if fused:  # --disable_automasking: no identity stack
            reproj = ssim_kernel.reprojection_losses(warped_srcs, target, opt.ssim_weight, ldt)
        else:
            target_l = target.to(ldt)
            tstats = L.ssim_target_stats(target_l) if use_ssim else None

            def stack(srcs):
                return L.reprojection_losses_stacked(
                    [x.to(ldt) for x in srcs], target_l, opt.ssim_weight, use_ssim,
                    tstats).float()

            reproj = stack(warped_srcs)
            if automasking:
                with torch.no_grad():
                    ident = stack(ident_srcs)
        to_optimise, automask = L.min_reprojection_loss(
            [reproj], [ident] if ident is not None else None, noise=noise,
            avg_reprojection=opt.avg_reprojection,
        )
    if automask is not None:
        outputs["automask"] = automask
    loss = to_optimise.mean()

    # 5. edge-aware smoothness on mean-normalised depth (trainer.py:533-542)
    norm_d = depth / (depth.mean(dim=(1, 2, 3), keepdim=True) + 1e-7)
    smooth = L.edge_aware_smoothness(
        norm_d, target, compute_dtype=None if ldt == torch.float32 else ldt)
    total = loss + opt.disparity_smoothness * smooth
    metrics = {"loss": total, "loss/reprojection": loss, "loss/smooth": smooth}
    return total, {"outputs": outputs, "metrics": metrics}
