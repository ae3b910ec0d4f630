"""ResNet feature-pyramid encoder. Counterpart of ``sfmnext_tpu/models/resnet.py``.

torchvision ResNet-18/34/50/101/152 (stride on the 3x3 of the bottleneck,
ResNet v1.5) with the monodepth2 five-level taps and the (x-0.45)/0.225
input normalisation. Parameter names are torchvision's under ``encoder.``,
as the reference's ``networks/resnet_encoder.py`` stores them. The JAX
package's variants (stacked input frames, SE, ECA, avg_down,
anti-aliasing, GroupNorm, deep stems, ResNeXt widths) are not ported yet
and raise.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from sfmnext_tpu_torch.models.common import BatchNorm2d

RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


def _downsample(cin, cout, stride):
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(_conv(cin, cout, 1, stride), BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = BatchNorm2d(features)
        self.downsample = _downsample(cin, features, stride)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        out = features * 4
        self.conv1 = _conv(cin, features, 1)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = BatchNorm2d(features)
        self.conv3 = _conv(features, out, 1)
        self.bn3 = BatchNorm2d(out)
        self.downsample = _downsample(cin, out, stride)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class _Trunk(nn.Module):
    """torchvision ResNet without its head: conv1, bn1, layer1..layer4."""

    def __init__(self, num_layers: int):
        super().__init__()
        kind, stages = RESNET_SPECS[num_layers]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for i, (width, n) in enumerate(zip((64, 128, 256, 512), stages)):
            blocks = []
            for j in range(n):
                blocks.append(block(cin, width, 2 if (j == 0 and i > 0) else 1))
                cin = width * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x) -> List[torch.Tensor]:
        y = F.relu(self.bn1(self.conv1(x)))
        feats = [y]
        y = F.max_pool2d(y, 3, 2, 1)
        for i in range(1, 5):
            y = getattr(self, f"layer{i}")(y)
            feats.append(y)
        return feats


class ResNetEncoder(nn.Module):
    """5-level pyramid [stem_relu, layer1, layer2, layer3, layer4], NCHW.

    Takes images [B,3,H,W] in [0,1] and normalises them with
    (x-0.45)/0.225.

    Args:
      num_layers: 18/34/50/101/152.
      dtype: compute and parameter dtype (the JAX ``dtype``; bf16 params
        hold exactly what JAX's per-use cast of f32 params computes with).
      **variants: the JAX package's other options (stacked input frames,
        SE, ECA, avg_down, anti-aliasing, GroupNorm, deep stems, ResNeXt
        widths); not ported yet.
    """

    def __init__(self, num_layers: int = 50, dtype=torch.float32, **variants):
        super().__init__()
        if variants:
            raise NotImplementedError(
                f"ResNet options {sorted(variants)} are not ported yet")
        if num_layers not in RESNET_SPECS:
            raise NotImplementedError(
                f"ResNet-{num_layers}: the port has {sorted(RESNET_SPECS)}")
        self.dtype = dtype
        self.encoder = _Trunk(num_layers)
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
