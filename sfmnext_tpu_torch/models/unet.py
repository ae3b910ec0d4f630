"""U-Net over a timm-style backbone (the reference's ``Unet``). Counterpart
of ``sfmnext_tpu/models/unet.py`` for its ConvNeXt and ResNet families.

The encoder's maps, deepest first, go through ``DecoderBlock``s of
[bilinear resize to the skip (align_corners=True), concat, 2x
(Conv3x3 without bias - BatchNorm - ReLU)]; the block after the last skip
doubles the map (align_corners=False); a 1x1 conv gives ``num_classes``
channels. The encoders (``unet_encoder``, in the JAX dispatch's order):
``convnext_*`` (four maps at strides 4..32); ``legacy_senet154`` /
``gluon_senet154`` (five, from stride 2); ResNeSt, ResNetV2 / BiT, the
ResNet variants (``parse_resnet_variant``), Res2Net and SK-ResNet, whose
stride-2 stem tap is dropped. With four decoder blocks the output lies at
1/2 of the input's resolution either way, where the SQL decoder expects
it. The weight-source prefixes ``ssl_`` / ``swsl_`` / ``tv_`` / ``ig_``
and ``gluon_*_v1b`` route to their base topology. The other families of
the zoo (``unet_zoo``), the bring-your-own-blocks ResNets among them,
raise ``NotImplementedError``. Parameter names are the reference's
(``encoder.*`` timm, ``decoder.blocks.<i>.conv<j>.{conv,bn}``,
``decoder.final_conv``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from sfmnext_tpu_torch.models.common import BatchNorm2d, kaiming_normal_fanout_
from sfmnext_tpu_torch.models.convnext import ConvNeXt, convnext_cfg
from sfmnext_tpu_torch.models.res2net import Res2Net
from sfmnext_tpu_torch.models.resnest import ResNeSt
from sfmnext_tpu_torch.models.resnet import RESNET_SPECS, ResNet
from sfmnext_tpu_torch.models.resnetv2 import ResNetV2
from sfmnext_tpu_torch.models.senet import SENET154_NAMES, SENet154
from sfmnext_tpu_torch.models.sknet import SKNet
from sfmnext_tpu_torch.models.unet_zoo import BYOB_NAMES
from sfmnext_tpu_torch.ops.image import resize_bilinear


class Conv2dBnAct(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, 3, padding=1, bias=False)
        self.bn = BatchNorm2d(features)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, skip: int, features: int):
        super().__init__()
        self.conv1 = Conv2dBnAct(cin + skip, features)
        self.conv2 = Conv2dBnAct(features, features)

    def forward(self, x, skip=None):
        if skip is not None:
            x = resize_bilinear(x, skip.shape[-2:], align_corners=True)
            x = torch.cat([x, skip.to(x.dtype)], dim=1)
        else:
            x = resize_bilinear(x, (2 * x.shape[-2], 2 * x.shape[-1]), align_corners=False)
        return self.conv2(self.conv1(x))


class UnetDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (1024, 512, 256, 128),
                 final_channels: int = 32):
        super().__init__()
        deepest_first = list(encoder_channels)[::-1]
        skips = deepest_first[1:]
        cin = deepest_first[0]
        blocks = []
        for i, ch in enumerate(decoder_channels):
            blocks.append(DecoderBlock(cin, skips[i] if i < len(skips) else 0, ch))
            cin = ch
        self.blocks = nn.ModuleList(blocks)
        self.final_conv = nn.Conv2d(cin, final_channels, 1)

    def forward(self, feats_deepest_first):
        x = feats_deepest_first[0]
        skips = feats_deepest_first[1:]
        for i, block in enumerate(self.blocks):
            x = block(x, skips[i] if i < len(skips) else None)
        return self.final_conv(x)


RESNET_PREFIXES = ("resnet", "resnext", "wide_resnet", "seresnet", "seresnext",
                   "legacy_seresnet", "legacy_seresnext", "ecaresnet")


def strip_weight_alias(backbone: str) -> str:
    """The routing name of a backbone: the weight-source prefixes (ssl_,
    swsl_, tv_, ig_, gluon v1b) share their base topology (JAX
    unet.py:211-217)."""
    for pre in ("ssl_", "swsl_", "tv_", "ig_"):
        if backbone.startswith(pre):
            backbone = backbone[len(pre):]
    if backbone.startswith("gluon_") and backbone.endswith("_v1b"):
        backbone = backbone[len("gluon_"):-len("_v1b")]
    return backbone


def parse_resnet_variant(name: str) -> dict:
    """An (alias-stripped) timm / torchvision ResNet-family name -> the
    ``ResNet`` trunk's keywords (JAX unet.py:81-192): the resnet / resnext
    / wide_resnet depth-width grammar, the [legacy_]se and eca prefixes,
    the gluon v1c / v1d / v1s deep stems, timm's d / t stem suffixes,
    resnetrs, the blur / aa anti-aliased names, resnet50_gn and
    ecaresnetlight. ValueError for a name it does not know."""
    full = name
    if name == "ecaresnetlight":
        # timm: bottleneck depths (1,1,11,3), avg-down shortcuts, ECA, the 7x7 stem
        return dict(num_layers=-1, groups=1, base_width=64, se_reduction=0, stem_type="",
                    stem_width=32, avg_down=True, attn="eca", replace_stem_pool=False, aa="",
                    norm="bn")
    if name == "resnet50_gn":
        return dict(num_layers=50, groups=1, base_width=64, se_reduction=0, stem_type="",
                    stem_width=32, avg_down=False, attn="", replace_stem_pool=False, aa="",
                    norm="gn")
    groups, base_width = 1, 64
    se_reduction = 0
    attn = ""
    stem_type, stem_width, avg_down = "", 32, False
    replace_stem_pool = False
    aa = ""
    # anti-aliased strides: resnetblur50 (blur pool), resnetaa50 /
    # seresnextaa101d_32x8d (average pool)
    for tok, kind in (("blur", "blur"), ("aa", "avg")):
        for fam in ("resnet", "resnext"):
            if name.startswith(f"{fam}{tok}") or (
                    name.startswith("se") and name[2:].startswith(f"{fam}{tok}")):
                aa = kind
                name = name.replace(f"{fam}{tok}", fam, 1)
    if name.startswith("gluon_"):
        # gluon_resnet50_v1c/v1d/v1s: deep stem (v1d adds avg-down
        # shortcuts, v1s widens the stem to 64); gluon_[se]resnext*: the
        # plain topology (the v1b names are stripped by the dispatch)
        base, variant = name[len("gluon_"):].rsplit("_", 1)
        if variant in ("v1c", "v1d", "v1s"):
            name = base
            stem_type = "deep"
            avg_down = variant == "v1d"
            stem_width = 64 if variant == "v1s" else 32
        else:
            name = name[len("gluon_"):]
    if name.startswith("legacy_"):
        name = name[len("legacy_"):]
    if name.startswith("eca"):
        attn = "eca"
        name = name[len("eca"):]
    if name.startswith("se"):
        se_reduction = 16
        name = name[len("se"):]

    def _dt_suffix(tail, stem_type, avg_down):
        # timm's suffixes: d = deep stem + avg-down, t = deep tiered stem + avg-down
        if tail.endswith("d"):
            return tail[:-1], "deep", True
        if tail.endswith("t"):
            return tail[:-1], "deep_tiered", True
        return tail, stem_type, avg_down

    try:
        if name.startswith("resnetrs"):
            # ResNet-RS: deep stem, strided conv stem pool, avg-down, SE 1/4
            layers = int(name[len("resnetrs"):])
            stem_type, avg_down = "deep", True
            se_reduction, replace_stem_pool = 4, True
        elif name.startswith("resnext"):
            # resnext<depth>[d|t]_<groups>x<width>d
            depth, spec = name[len("resnext"):].split("_")
            depth, stem_type, avg_down = _dt_suffix(depth, stem_type, avg_down)
            groups, base_width = (int(v) for v in spec[:-1].split("x"))
            layers = int(depth)
        elif name.startswith("wide_resnet"):
            depth, mult = name[len("wide_resnet"):].split("_")
            layers, base_width = int(depth), 64 * int(mult)
        else:
            tail, stem_type, avg_down = _dt_suffix(name[len("resnet"):], stem_type, avg_down)
            layers = int(tail)
    except ValueError:
        raise ValueError(f"unknown resnet variant {full!r}") from None
    if layers not in RESNET_SPECS:
        raise ValueError(f"unknown resnet variant {full!r}")
    return dict(num_layers=layers, groups=groups, base_width=base_width,
                se_reduction=se_reduction, stem_type=stem_type, stem_width=stem_width,
                avg_down=avg_down, attn=attn, replace_stem_pool=replace_stem_pool, aa=aa,
                norm="bn")


def unet_encoder(backbone: str, dtype=torch.float32):
    """(trunk, the channels of its taps, the index of its first tap the
    decoder takes) of a Unet backbone, routed in the JAX dispatch's order
    (unet.py:218-379). Raises NotImplementedError for the families the
    port does not build."""
    name = strip_weight_alias(backbone)
    if backbone.startswith("convnext"):
        depths, dims = convnext_cfg(backbone)
        return ConvNeXt(depths, dims, dtype=dtype), list(dims), 0
    if name in SENET154_NAMES:
        trunk = SENet154(name)
        return trunk, trunk.out_channels, 0
    # the JAX dispatch takes the ByobNet names and Xception before the
    # ResNet family, which their prefixes would otherwise reach
    if name not in BYOB_NAMES and not name.startswith(("xception", "gluon_xception")):
        trunk = None
        if name.startswith("resnest"):
            trunk = ResNeSt(name)
        elif name.startswith("resnetv2_"):
            trunk = ResNetV2(name)
        elif name.startswith("gluon_") or name.startswith(RESNET_PREFIXES):
            trunk = ResNet(**parse_resnet_variant(name))
        elif name.startswith(("res2net", "res2next")):
            trunk = Res2Net(name)
        elif name.startswith(("skresnet", "skresnext")):
            trunk = SKNet(name)
        if trunk is not None:  # the stride-2 stem tap is dropped
            return trunk, trunk.out_channels[1:], 1
    raise NotImplementedError(
        f"Unet backbone {backbone!r}: the port builds the convnext_* and ResNet families "
        "(resnet* / resnext* / wide_resnet* / [legacy_]se* / eca* / gluon_* / resnest* / "
        "resnetv2_* / res2net* / skres* / senet154); the rest of the Unet zoo is "
        "ROADMAP.md queue 1 item 12")


class Unet(nn.Module):
    """Images [B,3,H,W] in [0,1] -> features [B,num_classes,H/2,W/2]
    (float32 in a bf16 model, as the JAX ``Unet`` returns them)."""

    def __init__(self, backbone: str = "convnext_large", num_classes: int = 32,
                 decoder_channels: Sequence[int] = (1024, 512, 256, 128), dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder, channels, self.first_tap = unet_encoder(backbone, dtype)
        self.decoder = UnetDecoder(channels, decoder_channels, num_classes)
        self.to(dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The encoder's init, then the decoder's: kaiming_normal_fanout
        convs, zero final bias, BatchNorm 1 / 0."""
        self.encoder.init_weights(generator)
        for m in self.decoder.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_normal_fanout_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def forward(self, x):
        feats = self.encoder(x.to(self.dtype))[self.first_tap:]
        return self.decoder(feats[::-1]).float()
