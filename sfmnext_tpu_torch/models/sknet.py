"""Selective-kernel trunks (Li et al., CVPR'19) for the Unet. Counterpart
of ``sfmnext_tpu/models/sknet.py``: ``skresnet18``, ``skresnet34`` and
``skresnext50_32x4d``.

``SelectiveKernel``: two 3x3 branches (dilation 1 and 2) at the block's
stride, each conv-BN-ReLU, and a softmax over the branches of a gate from
the global mean of their sum (1x1 reduce, BN, ReLU, 1x1 select). The
basic blocks put it in place of the first 3x3 with each branch on half of
the input channels (``split_input``, reduction 1/8); the ResNeXt
bottleneck in place of its grouped 3x3 (32 groups, reduction 1/16). A 7x7
stem; five taps [stem, layer1..4], NCHW; timm's names
(``conv1.paths.<p>.{conv,bn}``, ``conv1.attn.{fc_reduce,bn,fc_select}``,
``conv2.{conv,bn}``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from sfmnext_tpu_torch.models.common import BatchNorm2d, flax_default, jax_init_
from sfmnext_tpu_torch.models.resnet import _downsample

SKNET_CFG = {
    # name -> (block kind, stage sizes, cardinality, base_width)
    "skresnet18": ("basic", (2, 2, 2, 2), 1, 64),
    "skresnet34": ("basic", (3, 4, 6, 3), 1, 64),
    "skresnext50_32x4d": ("bottleneck", (3, 4, 6, 3), 32, 4),
}


class ConvBn(nn.Module):
    """conv (bias-free) then BatchNorm, the ReLU optional."""

    def __init__(self, cin, cout, k, stride=1, groups=1, dilation=1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, padding=dilation * (k // 2),
                              dilation=dilation, groups=groups, bias=False)
        self.bn = BatchNorm2d(cout)
        self.act = act

    def forward(self, x):
        y = self.bn(self.conv(x))
        return F.relu(y) if self.act else y


class SelectiveKernelAttn(nn.Module):
    def __init__(self, channels: int, rd: int, n_paths: int = 2):
        super().__init__()
        self.fc_reduce = flax_default(nn.Conv2d(channels, rd, 1, bias=False))
        self.bn = BatchNorm2d(rd)
        self.fc_select = flax_default(nn.Conv2d(rd, channels * n_paths, 1, bias=False))

    def forward(self, s):
        return self.fc_select(F.relu(self.bn(self.fc_reduce(s))))


class SelectiveKernel(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1, groups: int = 1,
                 rd_ratio: float = 1.0 / 16, split_input: bool = True):
        super().__init__()
        if split_input and cin % 2:
            raise ValueError(f"split_input needs an even number of channels, not {cin}")
        self.split_input, self.features = split_input, features
        path_in = cin // 2 if split_input else cin
        self.paths = nn.ModuleList(
            ConvBn(path_in, features, 3, stride, min(groups, path_in), dilation=d)
            for d in (1, 2))
        self.attn = SelectiveKernelAttn(features, max(1, int(features * rd_ratio)))

    def forward(self, x):
        inputs = x.chunk(2, 1) if self.split_input else (x, x)
        p0, p1 = (path(xin) for path, xin in zip(self.paths, inputs))
        a = self.attn((p0 + p1).mean((2, 3), keepdim=True))
        a = a.view(a.shape[0], 2, self.features, 1, 1).softmax(1)
        return p0 * a[:, 0] + p1 * a[:, 1]


class SKBasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = SelectiveKernel(cin, features, stride, rd_ratio=1.0 / 8, split_input=True)
        self.conv2 = ConvBn(features, features, 3, act=False)
        self.downsample = _downsample(cin, features, stride)

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class SKBottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1, groups: int = 32,
                 base_width: int = 4):
        super().__init__()
        out = features * 4
        width = int(features * (base_width / 64.0)) * groups
        self.conv1 = ConvBn(cin, width, 1)
        self.conv2 = SelectiveKernel(width, width, stride, groups, rd_ratio=1.0 / 16,
                                     split_input=False)
        self.conv3 = ConvBn(width, out, 1, act=False)
        self.downsample = _downsample(cin, out, stride)

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class SKNet(nn.Module):
    def __init__(self, variant: str = "skresnet18"):
        super().__init__()
        if variant not in SKNET_CFG:
            raise ValueError(f"unknown sknet variant {variant!r}")
        kind, stages, card, bw = SKNET_CFG[variant]
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        self.out_channels = [cin]  # the taps' channels
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512), stages)):
            blocks = []
            for j in range(n):
                stride = 2 if (j == 0 and i > 0) else 1
                if kind == "basic":
                    blocks.append(SKBasicBlock(cin, planes, stride))
                else:
                    blocks.append(SKBottleneck(cin, planes, stride, card, bw))
                cin = planes * blocks[-1].expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            self.out_channels.append(cin)

    def init_weights(self, generator: torch.Generator) -> None:
        """kaiming_normal_fanout convs, the attention's 1x1s flax's
        default; BatchNorm 1 / 0."""
        jax_init_(self, generator)

    def forward(self, x) -> List[torch.Tensor]:
        y = F.relu(self.bn1(self.conv1(x)))
        feats = [y]
        y = F.max_pool2d(y, 3, 2, 1)
        for i in range(1, 5):
            y = getattr(self, f"layer{i}")(y)
            feats.append(y)
        return feats
