"""Build the model bundle from Options. Counterpart of
``sfmnext_tpu/training/builder.py`` (``build_models`` + ``init_params``):
the encoder by ``--backbone`` (``resnet``: ResNet + DecoderBN; ``eff_b5``:
EfficientNet-B5 + DecoderBN; ``convnext*``: the ConvNeXt Unet), the SQL
decoder and, for training, the PoseCNN (none for ``--frame_ids 0
--use_stereo``) and (``--use_rectify_net``) the RectifyNet. The lite
ResNets, the other Unet backbones, the separate-ResNet and shared pose
nets and the predictive-mask network are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from sfmnext_tpu_torch.models import PoseCNN, RectifyNet, ResnetEncoderDecoder, SQLDecoder
from sfmnext_tpu_torch.models.efficientnet import BaseEncoderDecoder
from sfmnext_tpu_torch.models.unet import Unet


@dataclasses.dataclass
class ModelBundle:
    """The modules of one mode.

    Inference (``build_models(train=False)``): encoder and depth in eval
    mode, their parameters in the compute dtype. Training: every module in
    train mode (BatchNorm on batch statistics, dropout live) with float32
    parameters, which ``training/step.eval_mode`` switches to eval mode for
    the eval step; ``compute_dtype`` is what the pipeline runs them in
    (autocast).
    """

    encoder: nn.Module
    depth: nn.Module
    pose: Optional[nn.Module] = None
    rectify: Optional[nn.Module] = None
    compute_dtype: torch.dtype = torch.float32

    def modules(self):
        return {name: m for name, m in
                (("encoder", self.encoder), ("depth", self.depth), ("pose", self.pose),
                 ("rectify", self.rectify))
                if m is not None}


def compute_dtype(opt) -> torch.dtype:
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if opt.compute_dtype not in dtypes:
        raise ValueError(f"compute_dtype {opt.compute_dtype!r}: one of {sorted(dtypes)}")
    return dtypes[opt.compute_dtype]


def sql_ffn_dim(backbone: str) -> int:
    """The SQL decoder's transformer FFN width: 512 for the lite backbones,
    1024 otherwise (reference trainer.py:78-83)."""
    return 512 if backbone.endswith("_lite") else 1024


def build_encoder(opt, dtype) -> nn.Module:
    """The depth encoder-decoder of ``opt.backbone`` (JAX builder.py:50-75)."""
    if opt.backbone == "resnet":
        return ResnetEncoderDecoder(opt.num_layers, opt.num_features, opt.model_dim, dtype=dtype)
    if opt.backbone == "eff_b5":
        return BaseEncoderDecoder(opt.num_features, opt.model_dim, dtype=dtype)
    if opt.backbone in ("resnet_lite", "resnet18_lite"):
        raise NotImplementedError(
            f"backbone {opt.backbone!r} is not ported yet (ROADMAP.md queue 1 items 8-9)")
    return Unet(opt.backbone, opt.model_dim, tuple(opt.dec_channels), dtype=dtype)


def build_models(opt, device, train: bool = False, depth_only: bool = False) -> ModelBundle:
    """The bundle on ``device``, initialised from a ``torch.Generator``
    seeded with ``opt.seed`` in the JAX package's order: encoder, depth,
    pose, rectify. ``opt.use_pallas`` routes the SQL decoder through its
    kernels. ``depth_only`` leaves out the pose and rectify networks
    (metric finetuning trains the encoder and depth decoder alone); the
    encoder and decoder weights are those of the full bundle."""
    dtype = compute_dtype(opt)
    with torch.device("meta"):  # no default init: weights come from the generator
        modules = {
            "encoder": build_encoder(opt, dtype),
            "depth": SQLDecoder(
                embedding_dim=opt.model_dim, patch_size=opt.patch_size,
                num_heads=4, query_nums=opt.query_nums, dim_out=opt.dim_out,
                min_val=opt.min_depth, max_val=opt.max_depth,
                ffn_dim=sql_ffn_dim(opt.backbone), dtype=dtype,
                use_kernels=getattr(opt, "use_pallas", True),
            ),
        }
        if train and not depth_only:
            if opt.pose_model_type != "posecnn":
                raise NotImplementedError(
                    f"pose_model_type {opt.pose_model_type!r}: the port trains with the "
                    "PoseCNN only")
            if opt.use_pose_net:  # none for --frame_ids 0 --use_stereo
                modules["pose"] = PoseCNN(opt.num_pose_frames, dtype=dtype)
            if opt.use_rectify_net:
                modules["rectify"] = RectifyNet()
    generator = torch.Generator().manual_seed(opt.seed)
    for module in modules.values():
        module.to_empty(device="cpu")
        module.init_weights(generator)
        if train:
            module.float()  # float32 master weights, as the JAX params
        module.to(device).train(train)
    return ModelBundle(**modules, compute_dtype=dtype)
