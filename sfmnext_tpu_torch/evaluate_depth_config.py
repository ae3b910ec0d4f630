"""KITTI depth evaluation CLI on the PyTorch port. Counterpart of
``evaluate_depth_config.py`` (reference evaluate_depth_config.py:286-296):

    python -m sfmnext_tpu_torch.evaluate_depth_config args_files/<config>.txt \
        --eval_mono --load_weights_folder <folder> [--no_cuda]

A bare .txt positional is expanded as an @argfile. The forward runs in
float32 on the CUDA card, or on the CPU with --no_cuda; without a card and
without --no_cuda it raises.
"""

import sys

from sfmnext_tpu_torch.config import parse_options
from sfmnext_tpu_torch.evaluation import evaluate


def main(argv=None) -> dict:
    """Evaluate the command line's checkpoint; returns the metric row."""
    opt = parse_options(argv if argv is not None else sys.argv[1:])
    return evaluate(opt)


if __name__ == "__main__":
    main()
