"""Indoor self-supervised training CLI on the PyTorch port. Counterpart of
``train_indoor.py`` (reference train_indoor.py:15-23):

    python -m sfmnext_tpu_torch.train_indoor args_files/<config>.txt

The indoor pipeline (RectifyNet, occlusion-weighted / photo-geo losses) is
selected from the flags; otherwise as ``sfmnext_tpu_torch.train``.
"""

import sys

from sfmnext_tpu_torch.config import parse_options
from sfmnext_tpu_torch.training.trainer import Trainer


def main(argv=None):
    opt = parse_options(argv if argv is not None else sys.argv[1:])
    Trainer(opt).train()


if __name__ == "__main__":
    main()
