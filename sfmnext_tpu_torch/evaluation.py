"""Evaluation: the reference's eval protocol as a library. Counterpart of
``sfmnext_tpu/evaluation.py``.

Behavioral reference: evaluate_depth_config.py:62-277 —
  - batch-1 forward over the split's test_files           (:80-90, 127-162)
  - optional flip post-process blend                      (:132-134, 51-59)
  - resize pred to GT resolution (numpy, per-image)       (:231)
  - eigen crop                                            (:237-241)
  - per-image median scaling (mono) / 5.4x stereo factor  (:253-256, :27)
  - clamp [1e-3, 80], 7-metric mean row                   (:258-276)

GT comes from gt_depths.npz produced by ``export_gt_depth`` (reference
export_gt_depth.py:19-65).

The networks run in float32, as the JAX evaluation does, on the CUDA card
or, with ``--no_cuda``, the CPU: the SQL decoder takes its unfused route
(its kernels are bf16 only), so evaluation launches none of the port's
kernels. The per-image resize and metrics run on the host, because the
GT sizes differ from image to image. Nothing here needs PIL: the datasets
import it where they decode, and the benchmark export writes its PNGs with
``utils/logging.write_png``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from sfmnext_tpu_torch.device import disable_tf32, opt_device
from sfmnext_tpu_torch.ops import metrics as M
from sfmnext_tpu_torch.training.builder import build_models
from sfmnext_tpu_torch.training.step import eval_mode
from sfmnext_tpu_torch.utils import checkpoint as ckpt

MIN_DEPTH = 1e-3
MAX_DEPTH = 80.0
STEREO_SCALE_FACTOR = 5.4
METRIC_KEYS = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")


def resize_np_bilinear(arr: np.ndarray, out_hw) -> np.ndarray:
    """cv2.resize-equivalent bilinear (half-pixel centers, edge-clamped, no
    antialiasing) of a [H,W] array on the host, returned in the input's
    float dtype. It interpolates in float64: in float32, F.interpolate
    rounds its sample positions at KITTI's widths, and the result left the
    1e-6 agreement with the JAX resize that the tests hold it to."""
    x = torch.from_numpy(np.asarray(arr, np.float64))[None, None]
    y = F.interpolate(x, size=tuple(int(s) for s in out_hw), mode="bilinear",
                      align_corners=False, antialias=False)
    return y[0, 0].numpy().astype(np.result_type(arr.dtype, np.float32))


def load_eval_variables(opt, device):
    """The encoder and depth decoder in float32 and eval mode on ``device``,
    with the weights of ``--load_weights_folder``.

    The folder is the reference's layout (evaluate_depth_config.py:92-117),
    as ``utils/checkpoint.py`` and ``utils/torch_export.py`` write it:
    ``encoder.pth``, then ``depth.pth`` if present. Evaluation runs in f32
    for metric parity with the reference (training defaults to bf16).
    Returns the model bundle (``training/builder.ModelBundle``).
    """
    opt = dataclasses.replace(opt, compute_dtype="float32")
    models = build_models(opt, device)
    folder = opt.load_weights_folder
    if folder is None:
        print("WARNING: no --load_weights_folder; evaluating random init")
        return models
    ckpt.load_encoder_depth(folder, models)
    return models


def _log_attn_panels(writer, step, img, disp, energy):
    """Color, normalized disparity and up to 100 per-query attention maps
    (softmax over pixels, each map normalized) of the first <=4 images
    (reference evaluate_depth_config.py:137-151)."""
    h, w, q = energy.shape[1:]
    panels = {}
    for j in range(min(4, img.shape[0])):
        panels[f"color_0/{j}"] = img[j]
        d = disp[j]
        panels[f"disp_0/{j}"] = (d - d.min()) / (d.max() - d.min() + 1e-7)
        e = energy[j].reshape(-1, q)
        e = np.exp(e - e.max(0, keepdims=True))
        attn = (e / e.sum(0, keepdims=True)).reshape(h, w, q)
        for k in range(min(100, q)):
            a = attn[:, :, k]
            panels[f"attn_{j}/{k}"] = a / (a.max() + 1e-12)
    writer.images(step, panels)


def predict_depths(opt, models, loader, post_process: bool) -> np.ndarray:
    """The decoder's depth ``disp0`` [N,h,w] at its own resolution over
    the loader's batches, the models in eval mode on their device.

    Batches of any size (``--eval_batch_size``; the last may be short)
    give what batch 1 gives. With ``post_process`` the flipped copies ride
    in the same batch and are blended by ``ops/metrics.flip_postprocess``.
    ``--log_attn`` writes the SQL energy maps of each batch to
    <log_dir>/vis through ``MetricWriter``.
    """
    device = next(models.encoder.parameters()).device
    writer = None
    if opt.log_attn:
        from sfmnext_tpu_torch.utils.logging import MetricWriter

        writer = MetricWriter(opt.log_dir, "vis")
    preds = []
    with eval_mode(models), torch.inference_mode():
        for step, batch in enumerate(loader):
            img = torch.as_tensor(batch["color"][:, 0]).to(device)  # [n,H,W,3]
            n = img.shape[0]
            x = img.permute(0, 3, 1, 2)
            if post_process:
                x = torch.cat([x, x.flip(3)], 0)
            out = models.depth(models.encoder(x), return_energy=opt.log_attn)
            d = out["disp0"][:, 0]
            if post_process:
                d = M.flip_postprocess(d[:n], d[n:].flip(-1))
            d = d.cpu().numpy()
            if writer is not None:
                _log_attn_panels(writer, step, img.cpu().numpy(), d,
                                 out["energy"][:n].cpu().numpy())
            preds.append(d)
    if writer is not None:
        writer.close()
    return np.concatenate(preds, 0)


def evaluate_predictions(
    opt,
    pred_depths: np.ndarray,
    gt_depths,
    eval_split: str = "eigen",
    error_maps_out: Optional[list] = None,
) -> dict:
    """Crop/scale/clamp + 7-metric mean (evaluate_depth_config.py:209-277).

    If ``error_maps_out`` is a list, per-image |gt-pred|*mask maps at GT
    resolution are appended to it (reference :246-250, saved behind
    --save_pred_disps).
    """
    errors, ratios = [], []
    use_median = opt.eval_mono and not opt.disable_median_scaling

    for i in range(len(pred_depths)):
        gt = gt_depths[i]
        gh, gw = gt.shape
        pred = resize_np_bilinear(pred_depths[i], (gh, gw))
        pred = pred * opt.pred_depth_scale_factor
        if opt.eval_stereo:
            pred = pred * STEREO_SCALE_FACTOR

        if eval_split == "eigen":
            mask = (gt > MIN_DEPTH) & (gt < MAX_DEPTH)
            mask &= M.eigen_crop_mask(gh, gw)
        else:
            mask = gt > 0

        if error_maps_out is not None:
            error_maps_out.append(np.abs(gt - pred) * mask)

        p, g = pred[mask], gt[mask]
        if use_median:
            ratio = np.median(g) / np.median(p)
            ratios.append(ratio)
            p = p * ratio
        p = np.clip(p, MIN_DEPTH, MAX_DEPTH)
        errors.append(M.compute_depth_errors(g, p))

    mean = np.mean(np.asarray(errors), axis=0)
    result = dict(zip(METRIC_KEYS, mean))
    if ratios:
        r = np.asarray(ratios)
        result["med_ratio"] = float(np.median(r))
        result["std_ratio"] = float(np.std(r / np.median(r)))
    return result


def print_metric_row(result: dict):
    print("\n  " + ("{:>8} | " * 7).format(*METRIC_KEYS))
    print(("&{: 8.3f}  " * 7).format(*[result[k] for k in METRIC_KEYS]) + "\\\\")


def save_benchmark_predictions(preds: np.ndarray, save_dir: str):
    """Resize to 352x1216, 5.4/d uint16*256 pngs (evaluate_depth_config.py:195-207)."""
    from sfmnext_tpu_torch.utils.logging import write_png

    os.makedirs(save_dir, exist_ok=True)
    for idx in range(len(preds)):
        resized = resize_np_bilinear(preds[idx], (352, 1216))
        depth = np.clip(STEREO_SCALE_FACTOR / np.maximum(resized, 1e-8), 0, 80)
        depth = (depth * 256).astype(np.uint16)
        write_png(os.path.join(save_dir, f"{idx:010d}.png"), depth)


def evaluate(opt) -> dict:
    """Full split evaluation (CLI entry equivalent).

    Covers all reference codepaths of evaluate_depth_config.py:62-277:
    forward-or-external predictions (--ext_disp_to_eval, :167-176),
    eigen→benchmark id remap (:171-176), disparity/error-map dumps
    (--save_pred_disps, :178-186, :268-272), --no_eval early exit (:188-190),
    and benchmark-split png export (:192-207). The forward runs on the
    CUDA card, or on the CPU with ``--no_cuda``.
    """
    from sfmnext_tpu_torch.training.trainer import find_splits_dir

    disable_tf32()
    splits_dir = find_splits_dir()
    out_dir = opt.eval_out_dir or opt.load_weights_folder or "."

    if opt.ext_disp_to_eval:
        print(f"-> Loading predictions from {opt.ext_disp_to_eval}")
        preds = np.load(opt.ext_disp_to_eval)
        if opt.eval_eigen_to_benchmark:
            ids = np.load(
                os.path.join(splits_dir, "benchmark", "eigen_to_benchmark_ids.npy")
            )
            preds = preds[ids]
    else:
        if int(opt.eval_mono) + int(opt.eval_stereo) != 1:
            raise ValueError("choose exactly one of --eval_mono / --eval_stereo")
        from sfmnext_tpu_torch.data.loader import PrefetchLoader
        from sfmnext_tpu_torch.data.mono_dataset import read_lines
        from sfmnext_tpu_torch.training.trainer import make_dataset

        files = read_lines(
            os.path.join(splits_dir, opt.eval_split, "test_files.txt")
        )
        ds_opt = dataclasses.replace(opt, frame_ids=(0,), use_stereo=False)
        dataset = make_dataset(ds_opt, files, is_train=False)
        dataset.load_depth = False
        loader = PrefetchLoader(
            dataset, max(1, opt.eval_batch_size), shuffle=False,
            num_workers=opt.num_workers, drop_last=False,
        )

        models = load_eval_variables(opt, opt_device(opt))
        preds = predict_depths(opt, models, loader, opt.post_process)

    if opt.save_pred_disps:
        os.makedirs(out_dir, exist_ok=True)
        output_path = os.path.join(out_dir, f"disps_{opt.eval_split}_split.npy")
        print(f"-> Saving predicted disparities to {output_path}")
        np.save(output_path, preds)

    if opt.no_eval:
        print("-> Evaluation disabled. Done.")
        return {}

    if opt.eval_split == "benchmark":
        save_dir = os.path.join(out_dir, "benchmark_predictions")
        print(f"-> Saving out benchmark predictions to {save_dir}")
        save_benchmark_predictions(preds, save_dir)
        print("-> No ground truth is available for the KITTI benchmark, "
              "so not evaluating. Done.")
        return {}

    gt_path = os.path.join(splits_dir, opt.eval_split, "gt_depths.npz")
    gt_depths = np.load(gt_path, fix_imports=True, allow_pickle=True)["data"]

    error_maps = [] if opt.save_pred_disps else None
    result = evaluate_predictions(
        opt, preds, gt_depths, opt.eval_split, error_maps_out=error_maps
    )
    if error_maps is not None:
        error_map_path = os.path.join(out_dir, f"error_{opt.eval_split}_split.npy")
        print(f"-> Saving error maps to {error_map_path}")
        np.savez_compressed(
            error_map_path, data=np.array(error_maps, dtype="object")
        )
    print_metric_row(result)
    return result
