"""Build the model bundle from Options. Counterpart of
``sfmnext_tpu/training/builder.py`` (``build_models`` + ``init_params``)
for the ``resnet`` backbone: the encoder-decoder, the SQL decoder and, for
training, the PoseCNN. The separate-ResNet and shared pose nets, the
rectify and predictive-mask networks are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from sfmnext_tpu_torch.models import PoseCNN, ResnetEncoderDecoder, SQLDecoder


@dataclasses.dataclass
class ModelBundle:
    """The modules of one mode.

    Inference (``train=False``): encoder and depth in eval mode, their
    parameters in the compute dtype. Training: every module in train mode
    (BatchNorm on batch statistics, dropout live) with float32 parameters;
    ``compute_dtype`` is what the pipeline runs them in (autocast).
    """

    encoder: nn.Module
    depth: nn.Module
    pose: Optional[nn.Module] = None
    train: bool = False
    compute_dtype: torch.dtype = torch.float32

    def modules(self):
        return {name: m for name, m in
                (("encoder", self.encoder), ("depth", self.depth), ("pose", self.pose))
                if m is not None}


def compute_dtype(opt) -> torch.dtype:
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if opt.compute_dtype not in dtypes:
        raise ValueError(f"compute_dtype {opt.compute_dtype!r}: one of {sorted(dtypes)}")
    return dtypes[opt.compute_dtype]


def build_models(opt, device, train: bool = False) -> ModelBundle:
    """The bundle on ``device``, initialised from a ``torch.Generator``
    seeded with ``opt.seed`` in the JAX package's order: encoder, depth,
    pose. ``opt.use_pallas`` routes the SQL decoder through its kernels."""
    if opt.backbone != "resnet":
        raise NotImplementedError(
            f"backbone {opt.backbone!r}: the port builds 'resnet' only")
    dtype = compute_dtype(opt)
    with torch.device("meta"):  # no default init: weights come from the generator
        modules = {
            "encoder": ResnetEncoderDecoder(
                opt.num_layers, opt.num_features, opt.model_dim, dtype=dtype),
            "depth": SQLDecoder(
                embedding_dim=opt.model_dim, patch_size=opt.patch_size,
                num_heads=4, query_nums=opt.query_nums, dim_out=opt.dim_out,
                min_val=opt.min_depth, max_val=opt.max_depth, ffn_dim=1024,
                dtype=dtype, use_kernels=getattr(opt, "use_pallas", True),
            ),
        }
        if train:
            if opt.pose_model_type != "posecnn" or opt.use_stereo:
                raise NotImplementedError(
                    f"pose_model_type {opt.pose_model_type!r}"
                    f"{' with stereo' if opt.use_stereo else ''}: the port trains "
                    "with the PoseCNN on monocular frames only")
            modules["pose"] = PoseCNN(opt.num_pose_frames, dtype=dtype)
    generator = torch.Generator().manual_seed(opt.seed)
    for module in modules.values():
        module.to_empty(device="cpu")
        module.init_weights(generator)
        if train:
            module.float()  # float32 master weights, as the JAX params
        module.to(device).train(train)
    return ModelBundle(**modules, train=train, compute_dtype=dtype)
