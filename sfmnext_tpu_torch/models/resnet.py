"""ResNet feature-pyramid encoder and its variants. Counterpart of
``sfmnext_tpu/models/resnet.py``.

torchvision ResNet-10/14/18/26/34/50/101/152/200/269, ecaresnetlight's
(1,1,11,3) and the ResNet-RS depths (stride on the 3x3 of the bottleneck,
ResNet v1.5) with the monodepth2 five-level taps, and every option of the
JAX ``ResNetEncoder``: squeeze-excitation (``se_reduction``) or ECA
(``attn="eca"``) after the last norm of a block, avg-down shortcuts
(``avg_down``), the anti-aliased stride (``aa``: a blur or average pool
after the 3x3, which stays at stride 1, and in the stem pool), GroupNorm-32
(``norm="gn"``), deep stems (``stem_type`` ``deep`` / ``deep_tiered``,
``stem_width``), ResNet-RS's strided-conv stem pool
(``replace_stem_pool``) and ResNeXt / wide widths (``groups``,
``base_width``). Parameter names are timm's and torchvision's: ``conv1``
(a deep stem's ``conv1.{0,3,6}`` with ``conv1.{1,4}`` and ``bn1``),
``maxpool.{0,1}`` (the RS stem pool), ``layer<i>.<j>.{conv,bn}<k>``, the
attention always ``se`` (``se.fc1`` / ``se.fc2``, ECA's ``se.conv``) and
the shortcut ``downsample.{0,1}``, or ``downsample.{1,2}`` after the pool
of an avg-down shortcut. ``ResNetEncoder`` (plain torchvision depths,
no options) stores the trunk under ``encoder.``, as the reference's
``networks/resnet_encoder.py`` does, and normalises its input with
(x-0.45)/0.225; the Unet takes the bare trunk (``ResNet``), which does not
normalise.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from sfmnext_tpu_torch.models.common import (AAPool, AvgPool2x2Ceil, BatchNorm2d, EcaModule,
                                             GroupNorm32, SEModule, jax_init_)

RESNET_SPECS = {
    10: ("basic", (1, 1, 1, 1)),       # timm resnet10t
    14: ("bottleneck", (1, 1, 1, 1)),  # timm resnet14t
    18: ("basic", (2, 2, 2, 2)),
    26: ("bottleneck", (2, 2, 2, 2)),  # timm resnet26 / seresnext26 family
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
    200: ("bottleneck", (3, 24, 36, 3)),  # timm resnet200d
    269: ("bottleneck", (3, 30, 48, 8)),  # timm ecaresnet269d
    -1: ("bottleneck", (1, 1, 11, 3)),    # timm ecaresnetlight
    270: ("bottleneck", (4, 29, 53, 4)),  # resnetrs270
    350: ("bottleneck", (4, 36, 72, 4)),  # resnetrs350
    420: ("bottleneck", (4, 44, 87, 4)),  # resnetrs420
}


def _conv(cin, cout, k, stride=1, groups=1):
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, groups=groups, bias=False)


def _norm(c, kind="bn"):
    """BatchNorm (torch defaults) or GroupNorm-32 (timm resnet50_gn)."""
    if kind not in ("bn", "gn"):
        raise ValueError(f"norm {kind!r}: 'bn' or 'gn'")
    return GroupNorm32(c) if kind == "gn" else BatchNorm2d(c)


def _attn(channels, se_reduction, attn):
    """The block's attention: SE (width max(1, C // se_reduction)) or ECA."""
    if attn not in ("", "eca"):
        raise ValueError(f"attn {attn!r}: '' or 'eca'")
    if se_reduction and attn:
        raise ValueError("a block has SE or ECA, not both")
    if se_reduction:
        return SEModule(channels, max(1, channels // se_reduction))
    return EcaModule(channels) if attn else None


def _downsample(cin, cout, stride, avg_down=False, norm="bn"):
    """The projection shortcut, where the block changes the stride or the
    width; ``avg_down`` (ResNet-D): AvgPool(2, 2, ceil) then a stride-1
    1x1 (no pool at stride 1, timm's Identity)."""
    if stride == 1 and cin == cout:
        return None
    if avg_down:
        pool = AvgPool2x2Ceil() if stride != 1 else nn.Identity()
        return nn.Sequential(pool, _conv(cin, cout, 1), _norm(cout, norm))
    return nn.Sequential(_conv(cin, cout, 1, stride), _norm(cout, norm))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1, se_reduction: int = 0,
                 avg_down: bool = False, attn: str = ""):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = BatchNorm2d(features)
        self.se = _attn(features, se_reduction, attn)
        self.downsample = _downsample(cin, features, stride, avg_down)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.se is not None:
            y = self.se(y)
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1, groups: int = 1,
                 base_width: int = 64, se_reduction: int = 0, avg_down: bool = False,
                 attn: str = "", aa: str = "", norm: str = "bn"):
        super().__init__()
        out = features * 4
        width = int(features * (base_width / 64.0)) * groups
        anti_alias = bool(aa) and stride == 2
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = _norm(width, norm)
        # the stride on the 3x3 (v1.5); with aa it stays at 1 and the pool
        # after the activation takes it
        self.conv2 = _conv(width, width, 3, 1 if anti_alias else stride, groups)
        self.bn2 = _norm(width, norm)
        self.aa = AAPool(aa) if anti_alias else None
        self.conv3 = _conv(width, out, 1)
        self.bn3 = _norm(out, norm)
        self.se = _attn(out, se_reduction, attn)
        self.downsample = _downsample(cin, out, stride, avg_down, norm)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        if self.aa is not None:
            y = self.aa(y)
        y = self.bn3(self.conv3(y))
        if self.se is not None:
            y = self.se(y)
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNet(nn.Module):
    """The trunk without its head: the stem, its pool, layer1..layer4.
    Takes [B,C,H,W] in the compute dtype and returns the five taps
    [stem activation, layer1, ..., layer4], NCHW (the JAX
    ``ResNetEncoder``'s features without the input normalisation)."""

    def __init__(self, num_layers: int = 50, in_channels: int = 3, groups: int = 1,
                 base_width: int = 64, se_reduction: int = 0, stem_type: str = "",
                 stem_width: int = 32, avg_down: bool = False, attn: str = "",
                 replace_stem_pool: bool = False, aa: str = "", norm: str = "bn"):
        super().__init__()
        if num_layers not in RESNET_SPECS:
            raise NotImplementedError(
                f"ResNet-{num_layers}: the depths are {sorted(RESNET_SPECS)}")
        if stem_type not in ("", "deep", "deep_tiered"):
            raise ValueError(f"stem_type {stem_type!r}: '', 'deep' or 'deep_tiered'")
        kind, stages = RESNET_SPECS[num_layers]
        if kind == "basic":
            if groups != 1 or base_width != 64:
                raise ValueError("groups / base_width need bottleneck blocks (torchvision)")

            def block(cin, width, stride):
                return BasicBlock(cin, width, stride, se_reduction, avg_down, attn)
        else:
            def block(cin, width, stride):
                return Bottleneck(cin, width, stride, groups, base_width, se_reduction,
                                  avg_down, attn, aa, norm)

        if stem_type:
            # timm / gluon deep stem: 3x3 s2 + two 3x3 s1, ending at
            # 2 * stem_width channels; "tiered" narrows the first conv to
            # 3/4 of stem_width
            c0 = 3 * stem_width // 4 if stem_type == "deep_tiered" else stem_width
            self.conv1 = nn.Sequential(
                _conv(in_channels, c0, 3, 2), BatchNorm2d(c0), nn.ReLU(),
                _conv(c0, stem_width, 3), BatchNorm2d(stem_width), nn.ReLU(),
                _conv(stem_width, 2 * stem_width, 3))
            cin = 2 * stem_width
            self.bn1 = BatchNorm2d(cin)
        else:
            self.conv1 = _conv(in_channels, 64, 7, 2)
            cin = 64
            self.bn1 = _norm(cin, norm)
        self.out_channels = [cin]  # the taps' channels
        if replace_stem_pool:  # ResNet-RS: a strided conv in place of the max pool
            self.maxpool = nn.Sequential(_conv(cin, 64, 3, 2), BatchNorm2d(64), nn.ReLU())
            cin = 64
        elif aa:  # anti-aliased stem pool: max 3x3 s1, then the blur / avg stride
            self.maxpool = nn.Sequential(nn.MaxPool2d(3, 1, 1), AAPool(aa))
        else:
            self.maxpool = nn.MaxPool2d(3, 2, 1)
        expansion = 1 if kind == "basic" else 4
        for i, (width, n) in enumerate(zip((64, 128, 256, 512), stages)):
            blocks = []
            for j in range(n):
                blocks.append(block(cin, width, 2 if (j == 0 and i > 0) else 1))
                cin = width * expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            self.out_channels.append(cin)

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX ``ResNetEncoder``'s init: kaiming_normal_fanout convs,
        the attention's flax defaults, norms 1 / 0."""
        jax_init_(self, generator)

    def forward(self, x) -> List[torch.Tensor]:
        y = F.relu(self.bn1(self.conv1(x)))
        feats = [y]
        y = self.maxpool(y)
        for i in range(1, 5):
            y = getattr(self, f"layer{i}")(y)
            feats.append(y)
        return feats


class ResNetEncoder(nn.Module):
    """5-level pyramid [stem_relu, layer1, layer2, layer3, layer4], NCHW.

    Takes images [B,3n,H,W] in [0,1] (n frames stacked on channels) and
    normalises them with (x-0.45)/0.225.

    Args:
      num_layers: a depth of ``RESNET_SPECS``.
      dtype: compute and parameter dtype (the JAX ``dtype``; bf16 params
        hold exactly what JAX's per-use cast of f32 params computes with).
      num_input_images: n, the stacked frames (RectifyNet's encoder: 2).
    """

    def __init__(self, num_layers: int = 50, dtype=torch.float32, num_input_images: int = 1):
        super().__init__()
        self.dtype = dtype
        self.encoder = ResNet(num_layers, 3 * num_input_images)
        self.to(dtype)

    @staticmethod
    def feature_channels(num_layers: int) -> Sequence[int]:
        base = [64, 64, 128, 256, 512]
        if RESNET_SPECS[num_layers][0] == "bottleneck":
            return [base[0]] + [c * 4 for c in base[1:]]
        return base

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """torchvision's init: kaiming_normal(fan_out, relu) convs, BN 1/0."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                        nonlinearity="relu", generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.encoder(((x - 0.45) / 0.225).to(self.dtype))
