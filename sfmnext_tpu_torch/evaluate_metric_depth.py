"""Metric-depth evaluation of a saved (finetuned) checkpoint on the PyTorch
port. Counterpart of ``evaluate_metric_depth.py`` (reference
finetune/evaluate_metric_depth.py:19-222): the flip-TTA prediction in the
compute dtype, resized to each GT on the host, clipped to [min_depth_eval,
max_depth_eval] (NaN to the min, inf to the max); the mask gt in
(min_depth_eval, max_depth_eval), with the Garg or Eigen crop when asked
(NYU's Eigen crop is the inner box [45:471, 41:601]); the 9-metric dict
(a1, a2, a3, abs_rel, sq_rel, rmse, rmse_log, silog, log_10) averaged over
images.

    python -m sfmnext_tpu_torch.evaluate_metric_depth <model_conf.txt> \
        args_files/hisfog/ft/inc_kitti.txt \
        --checkpoint_path <folder with encoder.pth / depth.pth> [--no_cuda]

The finetune argfile brings --filenames_file_eval, --gt_path(_eval), the
depth range and --garg_crop; as in the JAX CLI, a bare .txt word is read as
an argfile, a list's path on the command line too. It runs on the CUDA
card, or on the CPU with --no_cuda.
"""

import functools
import sys

import numpy as np

from sfmnext_tpu_torch.config import parse_options
from sfmnext_tpu_torch.device import disable_tf32, opt_device
from sfmnext_tpu_torch.finetune.trainer import make_disp_fn, score
from sfmnext_tpu_torch.finetune_metric_depth import build_loaders, parse_ft
from sfmnext_tpu_torch.ops.metrics import eigen_crop_mask
from sfmnext_tpu_torch.training.builder import build_models
from sfmnext_tpu_torch.utils.checkpoint import load_encoder_depth


def crop_mask(gh: int, gw: int, garg: bool, eigen: bool, dataset: str):
    """The [gh,gw] evaluation crop, the Garg one when ``garg``, else the
    Eigen one."""
    if garg:  # the KITTI evaluation's crop, which it calls the Eigen crop
        return eigen_crop_mask(gh, gw)
    crop = np.zeros((gh, gw), bool)
    if dataset == "nyu":
        crop[45:471, 41:601] = True
    else:
        crop[int(0.3324324 * gh):int(0.91351351 * gh),
             int(0.0359477 * gw):int(0.96405229 * gw)] = True
    return crop


def evaluate(opt, ft_args, test_loader=None) -> dict:
    """The 9-metric dict of ``--checkpoint_path`` over ``test_loader``
    (batches of ``DepthDataset`` items), by default the --filenames_file_eval
    list through ``build_loaders``. The encoder and decoder keep float32
    weights and run under autocast in ``opt.compute_dtype``, as the
    finetune validation runs them."""
    disable_tf32()
    if not ft_args.checkpoint_path:
        raise SystemExit("--checkpoint_path is required")
    device = opt_device(opt)
    models = build_models(opt, device, train=True, depth_only=True)
    load_encoder_depth(ft_args.checkpoint_path, models)
    infer = make_disp_fn(models)
    if test_loader is None:
        _, test_loader = build_loaders(opt, ft_args, need_train=False)
    if test_loader is None:
        raise SystemExit("--ft_filenames_file_eval/--filenames_file_eval required")

    crop = None
    if ft_args.garg_crop or ft_args.eigen_crop:
        crop = functools.partial(crop_mask, garg=ft_args.garg_crop, eigen=ft_args.eigen_crop,
                                 dataset=opt.dataset)
    result = score(infer, test_loader, device, ft_args.min_depth_eval, ft_args.max_depth_eval,
                   crop)
    print({k: round(v, 4) for k, v in result.items()})
    return result


def main(argv=None) -> dict:
    ft_args, rest = parse_ft(list(argv if argv is not None else sys.argv[1:]))
    return evaluate(parse_options(rest), ft_args)


if __name__ == "__main__":
    main()
