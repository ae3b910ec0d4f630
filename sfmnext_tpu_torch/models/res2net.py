"""Res2Net trunks (Gao et al., TPAMI'21) for the Unet. Counterpart of
``sfmnext_tpu/models/res2net.py``: ``res2net50_{26w_4s,14w_8s,26w_6s,
26w_8s,48w_2s}``, ``res2net101_26w_4s`` and ``res2next50``.

The bottleneck's 1x1 widens to width x scale channels, split in ``scale``
chunks; each chunk but the last goes through a 3x3, in a cascade
(sp_i = conv(sp_{i-1} + x_i)) in a stride-1 block that keeps the width and
on its own in a stage's first block, whose last chunk is 3x3
average-pooled at the block's stride (the others pass it through); the
concatenation goes through the 1x1 to 4x the planes with the ResNet
residual. A 7x7 stem; five taps [stem, layer1..4], NCHW; timm's names
(``convs.<i>`` / ``bns.<i>``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from sfmnext_tpu_torch.models.common import BatchNorm2d, jax_init_
from sfmnext_tpu_torch.models.resnet import _conv, _downsample

# name -> (stage_sizes, base_width, scale, cardinality)
RES2NET_CFG = {
    "res2net50_26w_4s": ((3, 4, 6, 3), 26, 4, 1),
    "res2net50_14w_8s": ((3, 4, 6, 3), 14, 8, 1),
    "res2net50_26w_6s": ((3, 4, 6, 3), 26, 6, 1),
    "res2net50_26w_8s": ((3, 4, 6, 3), 26, 8, 1),
    "res2net50_48w_2s": ((3, 4, 6, 3), 48, 2, 1),
    "res2net101_26w_4s": ((3, 4, 23, 3), 26, 4, 1),
    "res2next50": ((3, 4, 6, 3), 4, 4, 8),
}


class Bottle2neck(nn.Module):
    def __init__(self, cin: int, planes: int, base_width: int = 26, scale: int = 4,
                 cardinality: int = 1, stride: int = 1):
        super().__init__()
        out = planes * 4
        self.width = width = int(planes * (base_width / 64.0)) * cardinality
        self.scale, self.stride = scale, stride
        self.is_first = stride > 1 or cin != out
        n_convs = scale if scale == 1 else scale - 1
        self.conv1 = _conv(cin, width * scale, 1)
        self.bn1 = BatchNorm2d(width * scale)
        self.convs = nn.ModuleList(_conv(width, width, 3, stride, cardinality)
                                   for _ in range(n_convs))
        self.bns = nn.ModuleList(BatchNorm2d(width) for _ in range(n_convs))
        self.conv3 = _conv(width * scale, out, 1)
        self.bn3 = BatchNorm2d(out)
        self.downsample = _downsample(cin, out, stride)  # None unless is_first

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        chunks = y.split(self.width, dim=1)
        outs, sp = [], None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            sp = chunks[i] if (i == 0 or self.is_first) else sp + chunks[i]
            sp = F.relu(bn(conv(sp)))
            outs.append(sp)
        if self.scale > 1:
            last = chunks[-1]
            outs.append(F.avg_pool2d(last, 3, self.stride, 1) if self.is_first else last)
        y = self.bn3(self.conv3(torch.cat(outs, 1)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class Res2Net(nn.Module):
    def __init__(self, variant: str = "res2net50_26w_4s"):
        super().__init__()
        if variant not in RES2NET_CFG:
            raise ValueError(f"unknown res2net variant {variant!r}")
        stages, bw, scale, card = RES2NET_CFG[variant]
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        self.out_channels = [cin]  # the taps' channels
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512), stages)):
            blocks = []
            for j in range(n):
                blocks.append(Bottle2neck(cin, planes, bw, scale, card,
                                          2 if (j == 0 and i > 0) else 1))
                cin = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            self.out_channels.append(cin)

    def init_weights(self, generator: torch.Generator) -> None:
        jax_init_(self, generator)

    def forward(self, x) -> List[torch.Tensor]:
        y = F.relu(self.bn1(self.conv1(x)))
        feats = [y]
        y = F.max_pool2d(y, 3, 2, 1)
        for i in range(1, 5):
            y = getattr(self, f"layer{i}")(y)
            feats.append(y)
        return feats
