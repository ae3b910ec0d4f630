"""Metric-depth finetuning (supervised SILog). Counterpart of
``sfmnext_tpu/finetune/``: ``trainer.py`` (AdamW + OneCycle, the per-sample
median rescale during training, SILog, the 0.1 global-norm clip, flip-TTA
validation) and ``dataloader.py`` (BTS-style kb-crop / rotate / flip /
gamma augmentation)."""

from sfmnext_tpu_torch.finetune.dataloader import DepthDataset  # noqa: F401
from sfmnext_tpu_torch.finetune.trainer import FinetuneTrainer, make_finetune_step  # noqa: F401
