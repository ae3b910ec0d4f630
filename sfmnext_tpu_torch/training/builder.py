"""Build the model bundle from Options. Counterpart of
``sfmnext_tpu/training/builder.py`` (``build_models`` + ``init_params``):
the encoder by ``--backbone`` (``resnet`` / ``resnet_lite``: ResNet +
DecoderBN; ``resnet18_lite``: the Lite model, ResNet-18 + DecoderBN(256);
``eff_b5``: EfficientNet-B5 + DecoderBN; any other name: the Unet over
that backbone, of the ConvNeXt or the ResNet family, ``models/unet.py``),
the SQL decoder (its FFN 512 wide for the lite backbones) and, for
training, the pose network by ``--pose_model_type`` (none for
``--frame_ids 0 --use_stereo``): the PoseCNN, a ResNet-18 pose encoder
over the pose frames with a PoseDecoder (``separate_resnet``), or a
PoseDecoder over the depth encoder's features (``shared``); then
(``--use_rectify_net``) the RectifyNet and (``--predictive_mask``) the
predictive mask. The rest of the Unet zoo raises ``NotImplementedError``
(``models/unet.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from sfmnext_tpu_torch.models import (LiteResnetEncoderDecoder, PoseCNN, PoseDecoder,
                                      PredictiveMask, RectifyNet, ResNetEncoder,
                                      ResnetEncoderDecoder, SQLDecoder)
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
    pose_encoder: Optional[nn.Module] = None  # --pose_model_type separate_resnet
    predictive_mask: Optional[nn.Module] = None  # --predictive_mask

    def modules(self):
        return {name: m for name, m in
                (("encoder", self.encoder), ("depth", self.depth),
                 ("pose_encoder", self.pose_encoder), ("pose", self.pose),
                 ("rectify", self.rectify), ("predictive_mask", self.predictive_mask))
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
    if opt.backbone in ("resnet", "resnet_lite"):
        return ResnetEncoderDecoder(opt.num_layers, opt.num_features, opt.model_dim, dtype=dtype)
    if opt.backbone == "resnet18_lite":
        return LiteResnetEncoderDecoder(opt.model_dim, dtype=dtype)
    if opt.backbone == "eff_b5":
        return BaseEncoderDecoder(opt.num_features, opt.model_dim, dtype=dtype)
    return Unet(opt.backbone, opt.model_dim, tuple(opt.dec_channels), dtype=dtype)


def resnet_layers(opt) -> int:
    """The depth encoder's ResNet depth: 18 for the Lite model, whatever
    ``--num_layers`` says, else ``--num_layers``."""
    return 18 if opt.backbone == "resnet18_lite" else opt.num_layers


def check_predictive_mask(opt) -> None:
    """The JAX package's conditions on ``--predictive_mask`` (its
    builder.py:128-137 and pipeline.py:212 assert them), as ValueErrors
    with the same words."""
    if not getattr(opt, "predictive_mask", False):  # serving passes a bare namespace
        return
    if not opt.disable_automasking:
        raise ValueError("When using predictive_mask, please disable automasking with "
                         "--disable_automasking")
    if opt.backbone not in ("resnet", "resnet_lite", "resnet18_lite"):
        raise ValueError("--predictive_mask needs a ResNet pyramid backbone")
    if opt.pose_model_type == "shared" and opt.use_pose_net:
        raise ValueError("predictive_mask + shared pose unsupported")


def build_pose(opt, dtype):
    """{name: module} of ``opt.pose_model_type``'s pose network (JAX
    builder.py:102-126): the PoseCNN over the stacked pose frames; a
    ResNet-18 over them (``pose_encoder``) with a PoseDecoder; or a
    PoseDecoder over the depth encoder's features of each pose frame."""
    n_pose = opt.num_pose_frames
    if opt.pose_model_type == "separate_resnet":
        return {"pose_encoder": ResNetEncoder(18, dtype=dtype, num_input_images=n_pose),
                "pose": PoseDecoder(ResNetEncoder.feature_channels(18)[-1], 1,
                                    2 if n_pose == 2 else n_pose - 1)}
    if opt.pose_model_type == "shared":
        return {"pose": PoseDecoder(opt.model_dim, num_input_features=n_pose)}
    if opt.pose_model_type == "posecnn":
        return {"pose": PoseCNN(n_pose, dtype=dtype)}
    raise ValueError(f"pose_model_type {opt.pose_model_type!r}: one of posecnn, "
                     "separate_resnet, shared")


def build_models(opt, device, train: bool = False, depth_only: bool = False) -> ModelBundle:
    """The bundle on ``device``, initialised from a ``torch.Generator``
    seeded with ``opt.seed`` in the JAX package's order: encoder, depth,
    pose encoder, pose, rectify, predictive mask. ``opt.use_pallas`` routes
    the SQL decoder through its kernels. ``depth_only`` leaves out the
    pose, rectify and mask networks (metric finetuning trains the encoder
    and depth decoder alone); the encoder and decoder weights are those of
    the full bundle."""
    check_predictive_mask(opt)
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
            if opt.use_pose_net:  # none for --frame_ids 0 --use_stereo
                modules.update(build_pose(opt, dtype))
            if opt.use_rectify_net:
                modules["rectify"] = RectifyNet()
            if opt.predictive_mask:  # one channel a source frame
                modules["predictive_mask"] = PredictiveMask(
                    ResNetEncoder.feature_channels(resnet_layers(opt)),
                    len(opt.all_frame_ids) - 1, opt.scales)
    generator = torch.Generator().manual_seed(opt.seed)
    for module in modules.values():
        module.to_empty(device="cpu")
        module.init_weights(generator)
        if train:
            module.float()  # float32 master weights, as the JAX params
        module.to(device).train(train)
    return ModelBundle(**modules, compute_dtype=dtype)
