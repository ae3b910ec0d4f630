"""Build the depth model bundle from Options. Counterpart of
``sfmnext_tpu/training/builder.py`` (``build_models`` + ``init_params``),
for the ``resnet`` backbone's encoder and SQL decoder; the pose, rectify
and predictive-mask networks of the training path are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from sfmnext_tpu_torch.models import ResnetEncoderDecoder, SQLDecoder


@dataclasses.dataclass
class ModelBundle:
    """The inference modules, in eval mode."""

    encoder: nn.Module
    depth: nn.Module


def compute_dtype(opt) -> torch.dtype:
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if opt.compute_dtype not in dtypes:
        raise ValueError(f"compute_dtype {opt.compute_dtype!r}: one of {sorted(dtypes)}")
    return dtypes[opt.compute_dtype]


def build_models(opt, device) -> ModelBundle:
    """Encoder + SQL decoder on ``device``, initialised from a
    ``torch.Generator`` seeded with ``opt.seed`` (encoder first, as the JAX
    package splits its key)."""
    if opt.backbone != "resnet":
        raise NotImplementedError(
            f"backbone {opt.backbone!r}: the port builds 'resnet' only")
    dtype = compute_dtype(opt)
    with torch.device("meta"):  # no default init: weights come from the generator
        encoder = ResnetEncoderDecoder(
            opt.num_layers, opt.num_features, opt.model_dim, dtype=dtype
        )
        depth = SQLDecoder(
            embedding_dim=opt.model_dim, patch_size=opt.patch_size,
            num_heads=4, query_nums=opt.query_nums, dim_out=opt.dim_out,
            min_val=opt.min_depth, max_val=opt.max_depth, ffn_dim=1024,
            dtype=dtype,
        )
    generator = torch.Generator().manual_seed(opt.seed)
    for module in (encoder, depth):
        module.to_empty(device="cpu")
        module.init_weights(generator)
    return ModelBundle(encoder.to(device).eval(), depth.to(device).eval())
