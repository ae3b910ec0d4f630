"""The self-supervised forward and loss. Counterpart of
``sfmnext_tpu/training/pipeline.py`` (reference trainer.py:266-549):
``predict_poses`` (the PoseCNN, the separate ResNet-18 and the shared
encoder's pose nets, over frame pairs or all frames at once) and
``forward`` (photometric stack with SSIM or, under ``--no_ssim``, L1
alone; min-reprojection with automasking, or its ``--avg_reprojection``
variant; the ``--predictive_mask`` weighting; edge-aware smoothness) and
``train_depth_metrics`` (the train-time depth metrics against ground
truth). The indoor pipeline is ``training/indoor.py``.

The batch is the JAX package's: ``color`` and ``color_aug`` [B,F,H,W,3]
with F following ``opt.all_frame_ids``, ``K`` and ``inv_K`` [B,4,4] and,
with ``--use_stereo``, ``stereo_T`` [B,4,4] (the stereo frame's
transform), all on the models' device. The networks run under autocast
in the compute dtype (their parameters stay float32, as flax keeps its
params); depth, geometry, warps and losses run outside it, the geometry
and warps in float32. With ``opt.use_pallas`` the SQL decoder, the warps and the SSIM
loss go through the Hopper kernels (their plain versions for CPU
tensors), as the JAX package routes them on a TPU; without it, through
the plain ops. The route depends on ``opt.use_pallas`` alone, in the
train step and in the eval step alike, here and in the indoor pipeline:
the JAX package takes its Pallas warp in training only, but the kernel
and the plain sample compute the same bilinear sample.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from sfmnext_tpu_torch.models.common import batchnorm_recompute
from sfmnext_tpu_torch.ops import geometry, losses as L, metrics as M, ssim_kernel
from sfmnext_tpu_torch.ops.image import resize_bilinear
from sfmnext_tpu_torch.ops.warp import warp_frame


def autocast(models, device: torch.device):
    """The networks' compute dtype as autocast (off for float32)."""
    bf16 = models.compute_dtype == torch.bfloat16
    return torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def encode(models, x: torch.Tensor, opt) -> torch.Tensor:
    """The depth encoder's forward (for a Unet its decoder too), under an
    activation checkpoint with ``--remat`` (JAX pipeline.py:198-206: memory
    for a second forward in the backward). The recompute leaves the
    BatchNorm running statistics alone, so they move once a step."""
    if not opt.remat:
        return models.encoder(x)
    return checkpoint(models.encoder, x, use_reentrant=False, preserve_rng_state=True,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          batchnorm_recompute(models.encoder)))


def predict_poses(models, batch, frame_ids, opt, pose_frames=None, shared_feats=None):
    """Poses of the sources against the target (JAX pipeline.py:45-180,
    reference trainer.py:301-361).

    Pairs (``--pose_model_input pairs``): each temporal source with the
    target, in temporal order (earlier frame first). The PoseCNN takes all
    pairs in one batched forward (it has no BatchNorm); the separate
    ResNet-18 takes one forward a pair, in ``frame_ids[1:]`` order, so its
    BatchNorm statistics update once a pair in that order, as the JAX
    package threads them; the shared PoseDecoder takes the depth encoder's
    features of the pair (``shared_feats``). A past frame's transform is
    inverted (trainer.py:324-331).

    All frames (``--pose_model_input all``): one forward over every
    temporal frame predicts a pose for each source, with no inversion of
    past frames (a reference quirk, trainer.py:355-360, kept).

    ``pose_frames`` [B,F,H,W,3] replaces ``batch["color_aug"]`` as the
    nets' input (the indoor pipeline feeds the raw target and the rectified
    references, trainer_indoor.py:439-444).
    Returns {frame_id: (axisangle [B,3], translation [B,3], invert)}.
    """
    color_aug = batch["color_aug"] if pose_frames is None else pose_frames
    dev = color_aug.device
    shared = opt.pose_model_type == "shared"

    def net(frames):  # frames stacked on channels, NHWC
        with autocast(models, dev):
            if models.pose_encoder is not None:
                return models.pose([models.pose_encoder(_nchw(frames))])
            return models.pose(_nchw(frames))

    def decode_shared(frame_ids_in):
        with autocast(models, dev):
            return models.pose([[shared_feats[i]] for i in frame_ids_in])

    if opt.num_pose_frames != 2:  # all frames at once
        temporal = [f_i for f_i in frame_ids if f_i != "s"]
        if shared:
            axisangle, translation = decode_shared(temporal)
        else:
            axisangle, translation = net(torch.cat(
                [color_aug[:, frame_ids.index(f_i)] for f_i in temporal], dim=-1))
        return {f_i: (axisangle[:, i, 0], translation[:, i, 0], False)
                for i, f_i in enumerate(temporal[1:])}

    srcs = [(idx, f_i) for idx, f_i in enumerate(frame_ids[1:], start=1) if f_i != "s"]
    order = {f_i: ([idx, 0] if f_i < 0 else [0, idx]) for idx, f_i in srcs}

    def pair(f_i):
        return torch.cat([color_aug[:, i] for i in order[f_i]], dim=-1)

    if opt.pose_model_type == "posecnn":
        axisangle, translation = net(torch.cat([pair(f_i) for _, f_i in srcs], dim=0))
        b = color_aug.shape[0]
        return {f_i: (axisangle[j * b:(j + 1) * b, 0, 0], translation[j * b:(j + 1) * b, 0, 0],
                      f_i < 0)
                for j, (_, f_i) in enumerate(srcs)}
    poses = {}
    for _, f_i in srcs:
        if shared:
            axisangle, translation = decode_shared([f_i, 0] if f_i < 0 else [0, f_i])
        else:
            axisangle, translation = net(pair(f_i))
        poses[f_i] = (axisangle[:, 0, 0], translation[:, 0, 0], f_i < 0)
    return poses


def forward(models, batch, opt, generator=None):
    """Depth, poses, warps and losses of one batch.

    Args:
      models: a training ``ModelBundle``.
      batch: the tensors described in the module docstring.
      opt: Options.
      generator: a ``torch.Generator`` on the batch's device for the
        identity losses' tie-break noise (1e-5 * N(0,1)), drawn in each
        route's JAX shape: [1,H,W,n_sources] into the fused min,
        [1,H,W,1] under ``--avg_reprojection``; None adds none.
    Returns:
      (total loss, {"outputs", "metrics"}); BatchNorm running statistics
      update in place.
    """
    frame_ids = opt.all_frame_ids
    color = batch["color"]
    dev = color.device
    b, _, h, w, _ = color.shape
    color_aug = batch["color_aug"]

    # 1. depth from the augmented target frame (trainer.py:286-288). With
    # the shared pose net every temporal frame goes through the depth
    # encoder as one batch (BatchNorm statistics over the whole stack) and
    # the depth decoder sees the target's part; the predictive mask reads
    # the encoder's pyramid
    shared_feats = pyramid = None
    with autocast(models, dev):
        if opt.pose_model_type == "shared" and models.pose is not None:
            temporal = [f_i for f_i in frame_ids if f_i != "s"]
            stacked = torch.cat([color_aug[:, frame_ids.index(f_i)] for f_i in temporal])
            feats = encode(models, _nchw(stacked), opt).chunk(len(temporal))
            shared_feats = dict(zip(temporal, feats))
            feats = shared_feats[0]
        elif models.predictive_mask is not None:
            feats, pyramid = models.encoder(_nchw(color_aug[:, 0]), return_pyramid=True)
        else:
            feats = encode(models, _nchw(color_aug[:, 0]), opt)
        dec = models.depth(feats)
    depth_half = dec["disp0"]  # [B,1,H/2,W/2] float32: depth, a reference quirk
    depth = resize_bilinear(depth_half, (h, w), align_corners=False).permute(0, 2, 3, 1)
    outputs = {"depth": depth, "bin_centers": dec["bin_centers"]}

    # 2. poses (no pose net for --frame_ids 0 --use_stereo); PoseCNN
    # translations scale by the mean inverse depth without --use_stereo
    # (trainer.py:412-421), the other pose nets' do not
    poses = {} if models.pose is None else predict_poses(
        models, batch, frame_ids, opt, shared_feats=shared_feats)
    mean_inv_depth = (1.0 / depth).mean(dim=(1, 2, 3))

    # 3. warp every source frame into the target view; the stereo frame
    # "s" by the batch's stereo_T
    K, inv_K = batch["K"], batch["inv_K"]
    target = color[:, 0].contiguous()  # the loss kernels' [B,H,W,3] layout
    loss_dtype = opt.compute_dtype if opt.loss_dtype == "auto" else opt.loss_dtype
    ldt = torch.bfloat16 if loss_dtype == "bfloat16" else torch.float32
    warped_srcs, ident_srcs = [], []
    for idx, f_i in enumerate(frame_ids[1:], start=1):
        if f_i == "s":
            T = batch["stereo_T"]
        else:
            axisangle, translation, invert = poses[f_i]
            if opt.pose_model_type == "posecnn" and not opt.use_stereo:
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
    mask_loss = 0.0
    if fused and automasking and not opt.avg_reprojection:
        # the SSIM stacks, the identity stack, the noise and the min in the
        # kernels; the identities' maps never reach device memory
        noise = None if generator is None else L.tiebreak_noise(
            generator, (1, h, w, len(ident_srcs)))
        to_optimise, automask = ssim_kernel.reprojection_min(
            warped_srcs, ident_srcs, target, noise, opt.ssim_weight, ldt)
    else:
        ident = None
        if fused:  # the maps in the kernels, the min (averaged or not) here
            reproj = ssim_kernel.reprojection_losses(warped_srcs, target, opt.ssim_weight, ldt)
            if automasking:
                ident = ssim_kernel.identity_losses(ident_srcs, target, opt.ssim_weight, ldt)
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
        if pyramid is not None:
            # the predictive mask (needs --disable_automasking) weights each
            # source's map, and 0.2 * BCE(mask, 1) keeps it from collapsing
            # to 0 (trainer.py:495-507)
            pmask = models.predictive_mask(pyramid)[("disp", 0)].permute(0, 2, 3, 1)
            outputs["predictive_mask"] = pmask  # [B,H,W,n_sources]
            reproj = reproj * pmask
            mask_loss = 0.2 * (-torch.log(pmask.clamp(1e-7, 1.0))).mean()
        to_optimise, automask = L.min_reprojection_loss(
            [reproj], [ident] if ident is not None else None, generator=generator,
            avg_reprojection=opt.avg_reprojection,
        )
    if automask is not None:
        outputs["automask"] = automask
    loss = to_optimise.mean()

    # 5. edge-aware smoothness on mean-normalised depth (trainer.py:533-542)
    norm_d = depth / (depth.mean(dim=(1, 2, 3), keepdim=True) + 1e-7)
    smooth = L.edge_aware_smoothness(
        norm_d, target, compute_dtype=None if ldt == torch.float32 else ldt)
    total = loss + opt.disparity_smoothness * smooth + mask_loss
    metrics = {"loss": total, "loss/reprojection": loss, "loss/smooth": smooth}
    return total, {"outputs": outputs, "metrics": metrics}


def train_depth_metrics(depth, depth_gt, max_eval_depth: float = 80.0):
    """Train-time depth metrics with the garg crop and median scaling, on
    the tensors' device.

    depth [B,H,W,1] is resized to depth_gt's [B,gh,gw,1], clipped to
    [1e-3, max_eval_depth], scaled by the ratio of the masked medians of
    the batch (GT zeros are invalid) and clipped again (reference
    trainer.py:551-579). Returns ``ops/metrics.compute_depth_errors_masked``'s
    dict.
    """
    _, gh, gw, _ = depth_gt.shape
    pred = resize_bilinear(_nchw(depth), (gh, gw), align_corners=False).permute(0, 2, 3, 1)
    pred = pred.clamp(1e-3, max_eval_depth)
    crop = torch.zeros(gh, gw, dtype=torch.bool, device=depth_gt.device)
    # garg crop fractions of the KITTI full-resolution frame (trainer.py:566-567)
    crop[int(0.40810811 * gh):int(0.98948052 * gh), int(0.03542350 * gw):int(0.96378829 * gw)] = True
    mask = (depth_gt > 0) & crop[None, :, :, None]
    pred = pred * (_masked_median(depth_gt, mask) / (_masked_median(pred, mask) + 1e-7))
    pred = pred.clamp(1e-3, max_eval_depth)
    return M.compute_depth_errors_masked(depth_gt, pred, mask)


def _masked_median(x, mask):
    """The lower median of x's masked entries (index (n-1)//2 of them
    sorted, as the JAX package's padded sort takes it), +inf when none."""
    values = x[mask]
    if values.numel() == 0:
        return torch.tensor(float("inf"), device=x.device)
    return values.median()
