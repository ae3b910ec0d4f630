"""Cityscapes depth evaluation on the PyTorch port. Counterpart of
``tools/evaluate_depth_cityscapes_config.py``.

Behavioral reference: tools/evaluate_depth_cityscapes_config.py:110-367 —
  - CityscapesEvalDataset (raw frames, ego-car crop)
  - model output passed through disp_to_depth; the *scaled disparity* is
    then treated as the depth prediction (:214-216, the 1/disp inversion is
    disabled in the reference)
  - per-image npy GT; GT cropped to top 75% then center crop
    [256:, 192:1856] (:279-299)
  - mono: median scaling; stereo: 5.4x factor (:262-268)

    python -m sfmnext_tpu_torch.tools.evaluate_depth_cityscapes_config \
        args_files/<cfg>.txt --eval_mono --load_weights_folder <folder> [--no_cuda]

The forward runs in float32 on the CUDA card, or on the CPU with --no_cuda.
"""

import os
import sys

import numpy as np

from sfmnext_tpu_torch.evaluation import (
    MAX_DEPTH,
    METRIC_KEYS,
    MIN_DEPTH,
    STEREO_SCALE_FACTOR,
    print_metric_row,
    resize_np_bilinear,
)
from sfmnext_tpu_torch.ops import metrics as M
from sfmnext_tpu_torch.ops.geometry import disp_to_depth


def cityscapes_metrics(opt, raw: np.ndarray, gt_dir: str) -> dict:
    """The metric row of the decoder's outputs ``raw`` [N,h,w] against the
    per-image GT ``<gt_dir>/<i:03d>_depth.npy``."""
    # reference quirk: disp_to_depth's scaled_disp is used as the prediction
    preds, _ = disp_to_depth(raw, opt.min_depth, opt.max_depth)
    errors, ratios = [], []
    for i in range(len(preds)):
        gt = np.load(os.path.join(gt_dir, f"{i:03d}_depth.npy"))
        gh = int(round(gt.shape[0] * 0.75))
        gt = gt[:gh]
        pred = resize_np_bilinear(preds[i], (gh, gt.shape[1]))
        gt = gt[256:, 192:1856]
        pred = pred[256:, 192:1856]

        mask = (gt > MIN_DEPTH) & (gt < MAX_DEPTH)
        p, g = pred[mask], gt[mask]
        p = p * opt.pred_depth_scale_factor
        if opt.eval_stereo:
            p = p * STEREO_SCALE_FACTOR
        elif not opt.disable_median_scaling:
            r = np.median(g) / np.median(p)
            ratios.append(r)
            p = p * r
        p = np.clip(p, MIN_DEPTH, MAX_DEPTH)
        errors.append(M.compute_depth_errors(g, p))

    result = dict(zip(METRIC_KEYS, np.mean(np.asarray(errors), axis=0)))
    print_metric_row(result)
    return result


def evaluate_cityscapes(opt) -> dict:
    from sfmnext_tpu_torch.data.cityscapes import CityscapesEvalDataset
    from sfmnext_tpu_torch.data.loader import PrefetchLoader
    from sfmnext_tpu_torch.data.mono_dataset import read_lines
    from sfmnext_tpu_torch.device import disable_tf32, opt_device
    from sfmnext_tpu_torch.evaluation import load_eval_variables, predict_depths
    from sfmnext_tpu_torch.training.trainer import find_splits_dir

    disable_tf32()
    splits_dir = find_splits_dir()
    files = read_lines(os.path.join(splits_dir, "cityscapes", "test_files.txt"))
    ds = CityscapesEvalDataset(
        opt.eval_data_path, files, opt.height, opt.width,
        frame_idxs=[0], is_train=False, img_ext=".png",
    )
    loader = PrefetchLoader(ds, max(1, opt.eval_batch_size), shuffle=False, num_workers=2,
                            drop_last=False)
    models = load_eval_variables(opt, opt_device(opt))
    raw = predict_depths(opt, models, loader, opt.post_process)
    return cityscapes_metrics(opt, raw, os.path.join(splits_dir, "cityscapes", "gt_depths"))


def main(argv=None):
    from sfmnext_tpu_torch.config import parse_options

    opt = parse_options(argv if argv is not None else sys.argv[1:])
    evaluate_cityscapes(opt)


if __name__ == "__main__":
    main()
