"""Outdoor self-supervised training CLI on the PyTorch port. Counterpart of
``train.py`` (reference train.py:15-23):

    python -m sfmnext_tpu_torch.train args_files/<config>.txt [--no_cuda]

A bare .txt positional is expanded as an @argfile. It trains on the CUDA
card, or on the CPU with --no_cuda, on the --dataset under --data_path and
the split's file lists (``training/trainer.make_dataset``);
``Trainer(opt, train_loader, val_loader)`` takes batches directly.
"""

import sys

from sfmnext_tpu_torch.config import parse_options
from sfmnext_tpu_torch.training.trainer import Trainer


def main(argv=None):
    opt = parse_options(argv if argv is not None else sys.argv[1:])
    Trainer(opt).train()


if __name__ == "__main__":
    main()
