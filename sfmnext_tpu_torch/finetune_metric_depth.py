"""Metric-depth finetuning CLI on the PyTorch port. Counterpart of
``finetune_metric_depth.py`` (reference finetune/train_ft_SQLdepth.py):

    python -m sfmnext_tpu_torch.finetune_metric_depth <model_conf.txt> \
        args_files/hisfog/ft/inc_kitti.txt [--no_cuda]

The model argfile and the finetune argfile, with the reference's flag
names (--bs/--lr/--wd/--epochs/--filenames_file/--gt_path/...) or the
repo's (--ft_*); a bare .txt positional is expanded as an @argfile. It
trains on the CUDA card, or on the CPU with --no_cuda.

As in the JAX package, --div_factor / --final_div_factor, --do_random_rotate
/ --degree, --do_kb_crop / --garg_crop / --eigen_crop (for training),
--w_chamfer and the reference's bookkeeping flags are parsed and not
read: the schedule keeps div 25 and final div 100, the loader rotates by
up to 1 degree and kb-crops KITTI.
"""

import argparse
import sys

from sfmnext_tpu_torch.config import parse_options
from sfmnext_tpu_torch.data.loader import PrefetchLoader
from sfmnext_tpu_torch.device import disable_tf32
from sfmnext_tpu_torch.finetune import DepthDataset, FinetuneTrainer


class _ArgfileParser(argparse.ArgumentParser):
    def convert_arg_line_to_args(self, line):
        return line.split()


def _build_ft_parser():
    # allow_abbrev=False: otherwise argparse's prefix matching would take the
    # model conf's --min_depth/--max_depth for --min_depth_eval/--max_depth_eval
    p = _ArgfileParser(add_help=False, fromfile_prefix_chars="@", allow_abbrev=False)
    # the repo's names, with the reference finetune namespace as aliases
    p.add_argument("--ft_filenames_file", "--filenames_file", default=None)
    p.add_argument("--ft_filenames_file_eval", "--filenames_file_eval", default=None)
    p.add_argument("--ft_gt_path", "--gt_path", default=None)
    p.add_argument("--ft_lr", "--lr", type=float, default=1.6e-4)
    p.add_argument("--ft_wd", "--wd", type=float, default=0.1)
    p.add_argument("--ft_epochs", "--epochs", type=int, default=25)
    p.add_argument("--ft_batch_size", "--bs", type=int, default=4)
    p.add_argument("--ft_input_height", "--input_height", type=int, default=352)
    p.add_argument("--ft_input_width", "--input_width", type=int, default=1216)
    # reference finetune flags accepted for argfile compatibility and not read
    p.add_argument("--name", default=None)
    p.add_argument("--root", default=None)
    p.add_argument("--workers", type=int, default=None)
    p.add_argument("--validate_every", type=int, default=None)
    p.add_argument("--w_chamfer", type=float, default=0.0)
    p.add_argument("--div_factor", type=float, default=25.0)
    p.add_argument("--final_div_factor", type=float, default=100.0)
    p.add_argument("--do_random_rotate", action="store_true")
    p.add_argument("--degree", type=float, default=1.0)
    p.add_argument("--do_kb_crop", action="store_true")
    p.add_argument("--same_lr", action="store_true")
    # read by evaluate_metric_depth
    p.add_argument("--garg_crop", action="store_true")
    p.add_argument("--eigen_crop", action="store_true")
    p.add_argument("--min_depth_eval", type=float, default=1e-3)
    p.add_argument("--max_depth_eval", type=float, default=80.0)
    p.add_argument("--gt_path_eval", default=None)
    p.add_argument("--data_path_eval", default=None)
    p.add_argument("--checkpoint_path", default=None)
    return p


def parse_ft(argv):
    """Split argv into (finetune args, the rest for Options), a bare .txt
    positional expanded as an @argfile."""
    argv = [("@" + a) if (not a.startswith("-") and a.endswith(".txt")) else a for a in argv]
    return _build_ft_parser().parse_known_args(argv)


def build_loaders(opt, ft_args, need_train: bool = True):
    """(train loader or None, test loader or None) over ``DepthDataset``:
    training batches of --bs shuffled, the eval list at batch 1 in order."""
    train_loader = None
    if need_train:
        if not (ft_args.ft_filenames_file and ft_args.ft_gt_path):
            raise SystemExit("finetune needs --ft_filenames_file/--filenames_file and "
                             "--ft_gt_path/--gt_path")
        train_ds = DepthDataset(opt.data_path, ft_args.ft_gt_path, ft_args.ft_filenames_file,
                                mode="train", dataset=opt.dataset,
                                input_height=ft_args.ft_input_height,
                                input_width=ft_args.ft_input_width)
        train_loader = PrefetchLoader(train_ds, ft_args.ft_batch_size,
                                      num_workers=opt.num_workers)
    test_loader = None
    if ft_args.ft_filenames_file_eval:
        test_ds = DepthDataset(ft_args.data_path_eval or opt.data_path,
                               ft_args.gt_path_eval or ft_args.ft_gt_path,
                               ft_args.ft_filenames_file_eval, mode="eval", dataset=opt.dataset,
                               input_height=ft_args.ft_input_height,
                               input_width=ft_args.ft_input_width)
        test_loader = PrefetchLoader(test_ds, 1, shuffle=False, num_workers=1, drop_last=False)
    return train_loader, test_loader


def main(argv=None):
    ft_args, rest = parse_ft(list(argv if argv is not None else sys.argv[1:]))
    opt = parse_options(rest)
    disable_tf32()
    train_loader, test_loader = build_loaders(opt, ft_args)
    trainer = FinetuneTrainer(opt, train_loader, test_loader, lr=ft_args.ft_lr,
                              weight_decay=ft_args.ft_wd, epochs=ft_args.ft_epochs)
    trainer.train()
    if test_loader is not None:
        print(trainer.validate(max_depth=ft_args.max_depth_eval))
    return trainer


if __name__ == "__main__":
    main()
