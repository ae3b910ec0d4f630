"""SENet-154 trunk (Hu et al., CVPR'18) for the Unet. Counterpart of
``sfmnext_tpu/models/senet.py``: ``legacy_senet154`` and
``gluon_senet154`` (a weight-source alias of the same topology).

A 3x3 stem of 64 / 64 / 128 channels, then SE bottlenecks: a 1x1 to twice
the planes, a 3x3 in 64 groups to 4x the planes, a 1x1, SE (reduction
16), and 3x3 projection shortcuts. Five taps [stem, layer1..4], NCHW.
Parameter names are timm's ``legacy_senet154`` ones (``layer0.conv<i>``
/ ``layer0.bn<i>``, ``layer<i>.<j>.{conv,bn}<k>``, ``se_module.fc1`` /
``fc2``, ``downsample.{0,1}``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from sfmnext_tpu_torch.models.common import BatchNorm2d, SEModule, jax_init_
from sfmnext_tpu_torch.models.resnet import _conv

SENET154_NAMES = ("legacy_senet154", "gluon_senet154")


class SEBottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * 4
        self.conv1 = _conv(cin, planes * 2, 1)
        self.bn1 = BatchNorm2d(planes * 2)
        self.conv2 = _conv(planes * 2, out, 3, stride, groups=64)
        self.bn2 = BatchNorm2d(out)
        self.conv3 = _conv(out, out, 1)
        self.bn3 = BatchNorm2d(out)
        self.se_module = SEModule(out, max(1, out // 16))
        if stride != 1 or cin != out:
            self.downsample = nn.Sequential(_conv(cin, out, 3, stride), BatchNorm2d(out))
        else:
            self.downsample = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.se_module(self.bn3(self.conv3(y)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class _Stem(nn.Module):
    def __init__(self):
        super().__init__()
        for i, (cin, cout) in enumerate(((3, 64), (64, 64), (64, 128)), start=1):
            setattr(self, f"conv{i}", _conv(cin, cout, 3, 2 if i == 1 else 1))
            setattr(self, f"bn{i}", BatchNorm2d(cout))

    def forward(self, x):
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return x


class SENet154(nn.Module):
    def __init__(self, variant: str = "legacy_senet154"):
        super().__init__()
        if variant not in SENET154_NAMES:
            raise ValueError(f"unknown senet variant {variant!r}")
        self.layer0 = _Stem()
        cin = 128
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512), (3, 8, 36, 3))):
            blocks = []
            for j in range(n):
                blocks.append(SEBottleneck(cin, planes, 2 if (j == 0 and i > 0) else 1))
                cin = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    out_channels = [128, 256, 512, 1024, 2048]  # the taps' channels

    def init_weights(self, generator: torch.Generator) -> None:
        jax_init_(self, generator)

    def forward(self, x) -> List[torch.Tensor]:
        y = self.layer0(x)
        feats = [y]
        y = F.max_pool2d(y, 3, 2, 1)
        for i in range(1, 5):
            y = getattr(self, f"layer{i}")(y)
            feats.append(y)
        return feats
