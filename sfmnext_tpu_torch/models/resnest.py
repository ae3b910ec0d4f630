"""ResNeSt split-attention trunks (Zhang et al., '20) for the Unet.
Counterpart of ``sfmnext_tpu/models/resnest.py``: ``resnest14d/26d/50d/
101e/200e/269e`` and the ablations ``resnest50d_1s4x24d`` /
``resnest50d_4s2x40d``.

A deep stem (width 32 for the 'd' models, 64 for the 'e' ones) with
avg-down shortcuts; the bottleneck's 3x3 is a split-attention conv (radix
groups, the softmax over the radix of a gate from the radix sum's global
mean) and a 3x3 average pool takes the stride after it ("avd"). The
radix splits are channel-major, as the JAX module lays them out. Five taps
[stem, layer1..4], NCHW; timm's names (``conv1.{0,3,6}`` + ``conv1.{1,4}``
/ ``bn1``; ``layer<i>.<j>.conv2.{conv,bn0,fc1,bn1,fc2}``,
``downsample.{1,2}``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from sfmnext_tpu_torch.models.common import BatchNorm2d, flax_default, jax_init_
from sfmnext_tpu_torch.models.resnet import _conv, _downsample

# variant -> (depths, stem_width, radix, cardinality, base_width)
RESNEST_SPECS = {
    "resnest14d": ((1, 1, 1, 1), 32, 2, 1, 64),
    "resnest26d": ((2, 2, 2, 2), 32, 2, 1, 64),
    "resnest50d": ((3, 4, 6, 3), 32, 2, 1, 64),
    "resnest101e": ((3, 4, 23, 3), 64, 2, 1, 64),
    "resnest200e": ((3, 24, 36, 3), 64, 2, 1, 64),
    "resnest269e": ((3, 30, 48, 8), 64, 2, 1, 64),
    "resnest50d_1s4x24d": ((3, 4, 6, 3), 32, 1, 4, 24),
    "resnest50d_4s2x40d": ((3, 4, 6, 3), 32, 4, 2, 40),
}


class SplitAttnConv(nn.Module):
    """3x3 split-attention conv: ``channels`` outputs from a conv to
    radix x channels in radix x cardinality groups, gated by the
    r-softmax (a sigmoid at radix 1)."""

    def __init__(self, cin: int, channels: int, radix: int = 2, cardinality: int = 1):
        super().__init__()
        self.radix, self.channels = radix, channels
        inter = max(channels * radix // 4, 32)
        self.conv = _conv(cin, channels * radix, 3, groups=cardinality * radix)
        self.bn0 = BatchNorm2d(channels * radix)
        self.fc1 = nn.Conv2d(channels, inter, 1, groups=cardinality)
        self.bn1 = BatchNorm2d(inter)
        self.fc2 = flax_default(nn.Conv2d(inter, channels * radix, 1, groups=cardinality))

    def forward(self, x):
        r, c = self.radix, self.channels
        y = F.relu(self.bn0(self.conv(x)))
        b, _, h, w = y.shape
        splits = y.view(b, r, c, h, w)
        gap = splits.sum(1).mean((2, 3), keepdim=True)
        a = self.fc2(F.relu(self.bn1(self.fc1(gap))))
        if r > 1:
            att = a.view(b, r, c, 1, 1).softmax(1)
            return (splits * att).sum(1)
        return y * torch.sigmoid(a)


class ResNeStBottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1, radix: int = 2,
                 cardinality: int = 1, base_width: int = 64):
        super().__init__()
        out = planes * 4
        width = int(planes * (base_width / 64.0)) * cardinality
        self.stride = stride
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = SplitAttnConv(width, width, radix, cardinality)
        self.conv3 = _conv(width, out, 1)
        self.bn3 = BatchNorm2d(out)
        self.downsample = _downsample(cin, out, stride, avg_down=True)

    def forward(self, x):
        y = self.conv2(F.relu(self.bn1(self.conv1(x))))
        if self.stride > 1:  # "avd": the pool takes the stride, conv2 stays at 1
            y = F.avg_pool2d(y, 3, 2, 1, count_include_pad=False)
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNeSt(nn.Module):
    def __init__(self, variant: str = "resnest50d"):
        super().__init__()
        if variant not in RESNEST_SPECS:
            raise ValueError(f"unknown resnest variant {variant!r}")
        depths, stem_w, radix, card, base_w = RESNEST_SPECS[variant]
        self.conv1 = nn.Sequential(
            _conv(3, stem_w, 3, 2), BatchNorm2d(stem_w), nn.ReLU(),
            _conv(stem_w, stem_w, 3), BatchNorm2d(stem_w), nn.ReLU(),
            _conv(stem_w, 2 * stem_w, 3))
        self.bn1 = BatchNorm2d(2 * stem_w)
        cin = 2 * stem_w
        self.out_channels = [cin]  # the taps' channels
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512), depths)):
            blocks = []
            for j in range(n):
                blocks.append(ResNeStBottleneck(cin, planes, 2 if (j == 0 and i > 0) else 1,
                                                radix, card, base_w))
                cin = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            self.out_channels.append(cin)

    def init_weights(self, generator: torch.Generator) -> None:
        """kaiming_normal_fanout convs (the split attention's fc1 too),
        fc2 flax's default; zero biases; BatchNorm 1 / 0."""
        jax_init_(self, generator)

    def forward(self, x) -> List[torch.Tensor]:
        y = F.relu(self.bn1(self.conv1(x)))
        feats = [y]
        y = F.max_pool2d(y, 3, 2, 1)
        for i in range(1, 5):
            y = getattr(self, f"layer{i}")(y)
            feats.append(y)
        return feats
