"""Pre-activation ResNetV2 / BiT trunks for the Unet. Counterpart of
``sfmnext_tpu/models/resnetv2.py``: ``resnetv2_50/101`` (BatchNorm, plain
convs), the BiT models ``resnetv2_{50,101,152}x{1,2,3,4}_bitm[_in21k]``
(GroupNorm-32, weight-standardised convs with TF "SAME" padding and a
"SAME" max pool), their ``bit_teacher`` / ``bit_distilled`` aliases, and
the deep-stem, avg-down ``resnetv2_50d_gn`` / ``resnetv2_50d_evos``
(EvoNorm-S0 for the latter).

``WSConv`` standardises its weight over each output's fan-in in float32
(eps 1e-10) on every call. The stage sums are tapped raw, the deepest with
the trunk's final norm-act: five taps [stem, stage0..3], NCHW. timm's
names: ``stem.conv`` (``stem.conv1..3``),
``stages.<i>.blocks.<j>.{norm1,conv1,norm2,conv2,norm3,conv3}``,
``downsample.conv``, ``norm``.
"""

from __future__ import annotations

import re
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from sfmnext_tpu_torch.models.common import (BatchNorm2d, GroupNorm32, avg_pool_2x2_s2_ceil,
                                             jax_init_)

RESNETV2_DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def resnetv2_cfg(variant: str):
    """A resnetv2_* name -> (depths, width_factor, norm, ws, stem)."""
    name = variant
    for suf in ("_in21k", "_384"):
        if name.endswith(suf):
            name = name[: -len(suf)]
    if name == "resnetv2_50x1_bit_distilled":
        name = "resnetv2_50x1_bitm"
    if name == "resnetv2_152x2_bit_teacher":
        name = "resnetv2_152x2_bitm"
    m = re.fullmatch(r"resnetv2_(\d+)x(\d+)_bitm", name)
    if m:
        return RESNETV2_DEPTHS[int(m.group(1))], int(m.group(2)), "gn", True, ""
    m = re.fullmatch(r"resnetv2_(\d+)", name)
    if m:
        return RESNETV2_DEPTHS[int(m.group(1))], 1, "bn", False, ""
    if name == "resnetv2_50d_gn":
        return RESNETV2_DEPTHS[50], 1, "gn", True, "deep"
    if name == "resnetv2_50d_evos":
        return RESNETV2_DEPTHS[50], 1, "evos", True, "deep"
    raise ValueError(f"unknown resnetv2 variant {variant!r}")


def _same_pads(x, k, stride):
    """F.pad's (left, right, top, bottom) for TF "SAME": ceil(size / stride)
    outputs, the odd pixel of the padding after."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return pads


class WSConv(nn.Conv2d):
    """A bias-free conv whose weight is standardised per output channel
    (BiT's StdConv), with "SAME" padding."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride, bias=False)

    def forward(self, x):
        w = self.weight.float()
        mu = w.mean((1, 2, 3), keepdim=True)
        var = w.var((1, 2, 3), unbiased=False, keepdim=True)
        w = ((w - mu) / torch.sqrt(var + 1e-10)).to(x.dtype)
        x = F.pad(x, _same_pads(x, self.kernel_size[0], self.stride[0]))
        return F.conv2d(x, w, stride=self.stride)


def _plain_conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


class BatchNormAct2d(BatchNorm2d):
    def forward(self, x):
        return F.relu(super().forward(x))


class GroupNormAct32(GroupNorm32):
    def forward(self, x):
        return F.relu(super().forward(x))


class EvoNorm2dS0(nn.Module):
    """EvoNorm-S0 (Liu et al., NeurIPS'20): x * sigmoid(v x) over the
    standard deviation of its group (32 groups where C allows, else 1;
    eps 1e-5), times ``weight`` plus ``bias``, in float32."""

    def __init__(self, channels: int):
        super().__init__()
        self.groups = 32 if channels % 32 == 0 else 1
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.v = nn.Parameter(torch.ones(channels))

    def reset_parameters(self):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        nn.init.ones_(self.v)

    def forward(self, x):
        b, c, h, w = x.shape
        xf = x.float()
        v, gamma, beta = (p.float().view(1, c, 1, 1) for p in (self.v, self.weight, self.bias))
        g = xf.view(b, self.groups, c // self.groups, h, w)
        std = torch.sqrt(g.var((2, 3, 4), unbiased=False, keepdim=True) + 1e-5)
        std = std.expand_as(g).reshape(b, c, h, w)
        return (xf * torch.sigmoid(v * xf) / std * gamma + beta).to(x.dtype)


def _norm_act(kind, c):
    return {"bn": BatchNormAct2d, "gn": GroupNormAct32, "evos": EvoNorm2dS0}[kind](c)


class _Shortcut(nn.Module):
    """The projection of the pre-activated input; ``avg_down``: AvgPool(2,
    2, ceil) then a stride-1 conv."""

    def __init__(self, conv, cin, cout, stride, avg_down):
        super().__init__()
        self.pool = avg_down and stride != 1
        self.conv = conv(cin, cout, 1, 1 if self.pool else stride)

    def forward(self, x):
        return self.conv(avg_pool_2x2_s2_ceil(x) if self.pool else x)


class PreactBottleneck(nn.Module):
    def __init__(self, cin: int, out: int, stride: int = 1, norm: str = "gn", ws: bool = True,
                 avg_down: bool = False):
        super().__init__()
        conv = WSConv if ws else _plain_conv
        mid = out // 4
        self.norm1 = _norm_act(norm, cin)
        self.conv1 = conv(cin, mid, 1)
        self.norm2 = _norm_act(norm, mid)
        self.conv2 = conv(mid, mid, 3, stride)
        self.norm3 = _norm_act(norm, mid)
        self.conv3 = conv(mid, out, 1)
        if stride != 1 or cin != out:
            self.downsample = _Shortcut(conv, cin, out, stride, avg_down)
        else:
            self.downsample = None

    def forward(self, x):
        xp = self.norm1(x)
        shortcut = x if self.downsample is None else self.downsample(xp)
        y = self.conv1(xp)
        y = self.conv2(self.norm2(y))
        y = self.conv3(self.norm3(y))
        return y + shortcut


class _Stem(nn.Module):
    def __init__(self, conv, stem_ch, deep):
        super().__init__()
        self.deep = deep
        if deep:  # three 3x3s, no norm between them (as the JAX trunk)
            self.conv1 = conv(3, stem_ch // 2, 3, 2)
            self.conv2 = conv(stem_ch // 2, stem_ch // 2, 3)
            self.conv3 = conv(stem_ch // 2, stem_ch, 3)
        else:
            self.conv = conv(3, stem_ch, 7, 2)

    def forward(self, x):
        if self.deep:
            return self.conv3(self.conv2(self.conv1(x)))
        return self.conv(x)


class _Stage(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x):
        return self.blocks(x)


class ResNetV2(nn.Module):
    def __init__(self, variant: str = "resnetv2_50x1_bitm"):
        super().__init__()
        depths, wf, norm, ws, stem = resnetv2_cfg(variant)
        conv = WSConv if ws else _plain_conv
        self.ws = ws
        stem_ch = 64 * wf
        self.stem = _Stem(conv, stem_ch, stem == "deep")
        cin = stem_ch
        self.out_channels = [cin]  # the taps' channels
        stages = []
        for si, (width, n) in enumerate(zip((256 * wf, 512 * wf, 1024 * wf, 2048 * wf), depths)):
            blocks = []
            for bi in range(n):
                blocks.append(PreactBottleneck(cin, width, 2 if (bi == 0 and si > 0) else 1,
                                               norm, ws, avg_down=bool(stem)))
                cin = width
            stages.append(_Stage(blocks))
            self.out_channels.append(cin)
        self.stages = nn.ModuleList(stages)
        self.norm = _norm_act(norm, cin)

    def init_weights(self, generator: torch.Generator) -> None:
        """kaiming_normal_fanout convs; norms (EvoNorm's v too) 1 / 0."""
        jax_init_(self, generator)
        for m in self.modules():
            if isinstance(m, EvoNorm2dS0):
                m.reset_parameters()

    def forward(self, x) -> List[torch.Tensor]:
        y = self.stem(x)
        feats = [y]
        if self.ws:  # BiT's "SAME" max pool
            y = F.max_pool2d(F.pad(y, _same_pads(y, 3, 2), value=float("-inf")), 3, 2)
        else:
            y = F.max_pool2d(y, 3, 2, 1)
        for stage in self.stages:
            y = stage(y)
            feats.append(y)
        feats[-1] = self.norm(feats[-1])  # the final norm-act on the deepest tap
        return feats
