"""ImageNet-pretrained encoder trunks (``--weights_init pretrained``).
Counterpart of ``sfmnext_tpu/utils/imagenet_init.py`` for the trunks the
port builds.

Behavioral reference:
  - networks/resnet_encoder.py:44,57 — torchvision ImageNet ResNet weights
    for the depth encoder; :55-61 tiles ``conv1.weight`` across stacked
    input frames and divides by the frame count;
  - networks/base_encoder.py:94 — gen-efficientnet ``tf_efficientnet_b5_ap``;
  - networks/Unet.py:114-117 — timm backbones (``<backbone>.pth``);
  - networks/rectify_net.py:13-15 — a pretrained 2-image ResNet-18;
  - the ``separate_resnet`` pose encoder: ResNet-18 over the pose frames
    (JAX imagenet_init.py:259-266).

The weights are state dicts (``resnet{N}.pth``,
``tf_efficientnet_b5_ap.pth``, ``<backbone>.pth`` of a Unet backbone, its
weight-source prefix kept: ``ig_resnext101_32x8d.pth``) in a local directory:
``$SFMNEXT_WEIGHTS``, else ``<repo>/weights``. Nothing is fetched: an
absent file raises ``FileNotFoundError`` with the expected path.
``--weights_init scratch`` skips all of this.
"""

from __future__ import annotations

import os
import re

import torch
import torch.nn as nn

from sfmnext_tpu_torch.models.resnet import ResNetEncoder
from sfmnext_tpu_torch.models.unet import (RESNET_PREFIXES, parse_resnet_variant,
                                           strip_weight_alias)
from sfmnext_tpu_torch.training.builder import resnet_layers


def weights_dir() -> str:
    env = os.environ.get("SFMNEXT_WEIGHTS", "")
    if env:
        return env
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(repo, "weights")


def weights_path(fname: str) -> str:
    """``fname`` in the weights directory; raises FileNotFoundError with
    the expected location when it is absent."""
    path = os.path.join(weights_dir(), fname)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"weights_init='pretrained' needs {fname} at {path} "
            f"(set $SFMNEXT_WEIGHTS or place the torch state_dict there; "
            f"pass '--weights_init scratch' for random init)"
        )
    return path


@torch.no_grad()
def load_imagenet_resnet(encoder: ResNetEncoder, num_layers: int, num_input_images: int = 1):
    """Load ``resnet{num_layers}.pth`` into ``encoder``'s trunk (its
    ``fc`` head dropped); a stem over n stacked frames takes ``conv1``
    tiled over the input channels and divided by n."""
    sd = torch.load(weights_path(f"resnet{num_layers}.pth"), map_location="cpu",
                    weights_only=True)
    sd = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    if num_input_images > 1:
        sd["conv1.weight"] = torch.cat([sd["conv1.weight"]] * num_input_images, 1) / num_input_images
    # older torchvision files carry no num_batches_tracked; nothing else may be missing
    missing, unexpected = encoder.encoder.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"resnet{num_layers}.pth does not fit the ResNet-{num_layers} trunk: "
                         f"missing {missing}, unexpected {unexpected}")


def _convnext_keys(key: str) -> str:
    """timm's naming variants of a convnext state dict -> the port's: the
    features_only flattening (``stages_0.`` -> ``stages.0.``), the block's
    ``conv_dw`` and ``mlp.fc1`` / ``mlp.fc2``."""
    key = re.sub(r"\bstages_(\d+)\.", r"stages.\1.", key)
    key = re.sub(r"\bstem_(\d+)\.", r"stem.\1.", key)
    key = key.replace(".mlp.fc1.", ".pwconv1.").replace(".mlp.fc2.", ".pwconv2.")
    return key.replace(".conv_dw.", ".dwconv.")


@torch.no_grad()
def load_imagenet_trunk(trunk: nn.Module, fname: str, rename=None) -> None:
    """Load ``fname`` (a state dict, or one under ``"model"``; a
    DataParallel ``module.`` prefix stripped; keys mapped by ``rename``)
    into ``trunk``. The file's keys that the trunk lacks (a classifier
    head, a final BatchNorm) are dropped; every key of the trunk but
    ``num_batches_tracked`` must be in the file."""
    sd = torch.load(weights_path(fname), map_location="cpu", weights_only=True)
    if "model" in sd and hasattr(sd["model"], "items"):
        sd = sd["model"]
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    if rename is not None:
        sd = {rename(k): v for k, v in sd.items()}
    own = trunk.state_dict()
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"{fname} does not fit the {type(trunk).__name__} trunk: "
                         f"missing {missing}")
    trunk.load_state_dict({k: v for k, v in sd.items() if k in own}, strict=False)


def _no_converter(backbone: str, why: str = "") -> NotImplementedError:
    return NotImplementedError(f"no ImageNet-init converter for backbone {backbone!r}{why}; "
                               "pass '--weights_init scratch'")


def load_imagenet_unet(trunk: nn.Module, backbone: str) -> None:
    """``<backbone>.pth`` (timm's names, which the port's trunks keep) into
    a Unet's trunk, for the families the JAX package converts
    (imagenet_init.py:168-212): ConvNeXt, ResNetV2 / BiT, ResNeSt and the
    ResNet variants but ResNet-RS and GroupNorm (the JAX converters read
    BatchNorm statistics there). Res2Net, SK-ResNet and SENet-154 have no
    converter there and raise here."""
    name = strip_weight_alias(backbone)
    fname = f"{backbone}.pth"
    if name.startswith("convnext"):
        return load_imagenet_trunk(trunk, fname, _convnext_keys)
    if name.startswith(("resnetv2_", "resnest")):
        return load_imagenet_trunk(trunk, fname)
    if name.startswith(RESNET_PREFIXES + ("gluon_",)) and not name.startswith("resnetrs"):
        try:
            kw = parse_resnet_variant(name)
        except ValueError as e:
            raise _no_converter(backbone, f" ({e})") from e
        weights_path(fname)  # a missing file raises first, as in JAX
        if kw["norm"] == "gn":
            raise NotImplementedError(
                f"ImageNet-init converter does not cover backbone {backbone!r} (missing key "
                "'bn1.running_mean'); pass '--weights_init scratch'")
        return load_imagenet_trunk(trunk, fname)
    raise _no_converter(backbone)


def apply_weights_init(opt, models) -> None:
    """ImageNet weights into the depth encoder's trunk (its decoder stays
    random, as in the reference; ``resnet18_lite`` takes ResNet-18 whatever
    ``--num_layers`` says), the ``separate_resnet`` pose encoder and
    RectifyNet's 2-image ResNet-18. No-op for ``--weights_init scratch``."""
    if opt.weights_init != "pretrained":
        return
    if opt.backbone == "eff_b5":
        load_imagenet_trunk(models.encoder.encoder.original_model, "tf_efficientnet_b5_ap.pth")
    elif opt.backbone in ("resnet", "resnet_lite", "resnet18_lite"):
        load_imagenet_resnet(models.encoder.encoder, resnet_layers(opt))
    else:
        load_imagenet_unet(models.encoder.encoder, opt.backbone)
    if getattr(models, "pose_encoder", None) is not None:  # separate_resnet
        load_imagenet_resnet(models.pose_encoder, 18, num_input_images=opt.num_pose_frames)
    if models.rectify is not None:
        load_imagenet_resnet(models.rectify.encoder, 18, num_input_images=2)
    print(f"-> ImageNet init from {weights_dir()} ({opt.backbone})")
