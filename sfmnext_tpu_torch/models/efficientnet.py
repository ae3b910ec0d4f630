"""EfficientNet trunk + BN decoder (the reference's ``eff_b5`` backbone).
Counterpart of ``sfmnext_tpu/models/efficientnet.py``.

Stem conv3x3 stride 2; seven stages of MBConv blocks [1x1 expand - BN -
SiLU (not in stage 0), depthwise kxk - BN - SiLU, squeeze-excite sized on
the block's *input* channels (two 1x1 convs with biases), 1x1 project -
BN, residual where the shape allows]; conv_head 1x1 to 2048. BatchNorm
with flax's momentum 0.99 (torch's 0.01) and eps 1e-3; TF "SAME"
padding: a stride-2 convolution pads by what its input size needs, the
extra pixel below and right (``Conv2dSame``). ``BaseEncoderDecoder``
taps stages 0, 1, 2 and 4 and the head (strides 2 to 32) into
``DecoderBN``. Parameter names are gen-efficientnet's under
``encoder.original_model.`` (reference networks/base_encoder.py:60-94).
"""

from __future__ import annotations

import math
import re
from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from sfmnext_tpu_torch.models.common import (
    BatchNorm2d,
    kaiming_normal_fanout_,
    lecun_normal_,
)
from sfmnext_tpu_torch.models.decoder_bn import DecoderBN

B0_CHANNELS = (16, 24, 40, 80, 112, 192, 320)
B0_REPEATS = (1, 2, 2, 3, 3, 4, 1)
KERNELS = (3, 3, 5, 3, 5, 5, 3)
STRIDES = (1, 2, 2, 2, 1, 2, 1)
EXPAND = (1, 6, 6, 6, 6, 6, 6)
# (width, depth) coefficients of each variant
EFFICIENTNET_COEFFS = {
    "efficientnet_b0": (1.0, 1.0),
    "efficientnet_b1": (1.0, 1.1),
    "efficientnet_b2": (1.1, 1.2),
    "efficientnet_b3": (1.2, 1.4),
    "efficientnet_b4": (1.4, 1.8),
    "efficientnet_b5": (1.6, 2.2),
    "efficientnet_b6": (1.8, 2.6),
    "efficientnet_b7": (2.0, 3.1),
    "efficientnet_b8": (2.2, 3.6),
    "efficientnet_l2": (4.3, 5.3),
}
BN_EPS, BN_MOMENTUM = 1e-3, 0.01  # flax momentum 0.99
SE_RATIO = 0.25
HEAD_CHANNELS = 2048


def _round_channels(ch: float) -> int:
    """timm/TF channel rounding (divisor 8, never below 90% of target)."""
    new = max(8, (int(ch + 4) // 8) * 8)
    if new < 0.9 * ch:
        new += 8
    return new


def efficientnet_cfg(name: str):
    """Stage config for any efficientnet_b* / tf_efficientnet_b*[_ap/_ns]."""
    m = re.search(r"efficientnet_(b\d|l2)", name)
    if not m or f"efficientnet_{m.group(1)}" not in EFFICIENTNET_COEFFS:
        raise ValueError(f"unknown efficientnet variant {name!r}")
    w, d = EFFICIENTNET_COEFFS[f"efficientnet_{m.group(1)}"]
    return dict(
        stem=_round_channels(32 * w),
        channels=tuple(_round_channels(c * w) for c in B0_CHANNELS),
        repeats=tuple(int(math.ceil(d * r)) for r in B0_REPEATS),
        kernels=KERNELS,
        strides=STRIDES,
        expand=EXPAND,
    )


B5_STAGES = efficientnet_cfg("efficientnet_b5")


class Conv2dSame(nn.Conv2d):
    """A bias-free convolution with TF "SAME" padding: the output has
    ceil(size / stride) pixels a side, and the total padding that needs is
    split with the odd pixel after (below, right)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1):
        # stride 1 and odd k: "SAME" is symmetric
        super().__init__(cin, cout, k, stride, padding=k // 2 if stride == 1 else 0,
                         groups=groups, bias=False)

    def forward(self, x):
        if self.stride[0] == 1:
            return super().forward(x)
        k, s = self.kernel_size[0], self.stride[0]
        pads = []
        for size in (x.shape[-1], x.shape[-2]):  # F.pad's order: width, then height
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads))


def _bn(c):
    return BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class SqueezeExcite(nn.Module):
    def __init__(self, mid: int, se_ch: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(mid, se_ch, 1)
        self.conv_expand = nn.Conv2d(se_ch, mid, 1)

    def forward(self, y):
        s = F.silu(self.conv_reduce(y.mean(dim=(2, 3), keepdim=True)))
        return y * torch.sigmoid(self.conv_expand(s))


class MBConv(nn.Module):
    """gen-efficientnet's ``DepthwiseSeparableConv`` (expand 1: conv_dw,
    bn1, se, conv_pw, bn2) or ``InvertedResidual`` (conv_pw, bn1, conv_dw,
    bn2, se, conv_pwl, bn3), by its parameter names."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, expand: int):
        super().__init__()
        mid = cin * expand
        self.expand = expand
        self.residual = stride == 1 and cin == cout
        dw = Conv2dSame(mid, mid, kernel, stride, groups=mid)
        se = SqueezeExcite(mid, max(1, int(cin * SE_RATIO)))
        if expand == 1:
            self.conv_dw, self.bn1, self.se = dw, _bn(mid), se
            self.conv_pw, self.bn2 = Conv2dSame(mid, cout, 1), _bn(cout)
        else:
            self.conv_pw, self.bn1 = Conv2dSame(cin, mid, 1), _bn(mid)
            self.conv_dw, self.bn2, self.se = dw, _bn(mid), se
            self.conv_pwl, self.bn3 = Conv2dSame(mid, cout, 1), _bn(cout)

    def forward(self, x):
        if self.expand == 1:
            y = F.silu(self.bn1(self.conv_dw(x)))
            y = self.bn2(self.conv_pw(self.se(y)))
        else:
            y = F.silu(self.bn1(self.conv_pw(x)))
            y = F.silu(self.bn2(self.conv_dw(y)))
            y = self.bn3(self.conv_pwl(self.se(y)))
        return y + x if self.residual else y


class EfficientNet(nn.Module):
    """The trunk of any b0..b7 variant: images [B,3,H,W] (no normalisation,
    as the JAX package feeds them) -> the reference eff_b5 decoder's taps
    [stage 0 (1/2), stage 1 (1/4), stage 2 (1/8), stage 4 (1/16),
    conv_head (1/32)] (reference base_encoder.py:41)."""

    def __init__(self, variant: str = "efficientnet_b5", dtype=torch.float32):
        super().__init__()
        cfg = efficientnet_cfg(variant)
        self.dtype = dtype
        self.conv_stem = Conv2dSame(3, cfg["stem"], 3, 2)
        self.bn1 = _bn(cfg["stem"])
        cin, stages = cfg["stem"], []
        for si in range(7):
            blocks = []
            for bi in range(cfg["repeats"][si]):
                blocks.append(MBConv(cin, cfg["channels"][si], cfg["kernels"][si],
                                     cfg["strides"][si] if bi == 0 else 1, cfg["expand"][si]))
                cin = cfg["channels"][si]
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        self.conv_head = Conv2dSame(cin, HEAD_CHANNELS, 1)
        c = cfg["channels"]
        self.feature_channels = (c[0], c[1], c[2], c[4], HEAD_CHANNELS)
        self.to(dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's init: kaiming_normal_fanout for the bias-free
        convs, flax's lecun_normal and zero biases for the squeeze-excite,
        BatchNorm 1 / 0."""
        for m in self.modules():
            if isinstance(m, Conv2dSame):
                kaiming_normal_fanout_(m.weight, generator)
            elif isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def forward(self, x) -> List[torch.Tensor]:
        y = F.silu(self.bn1(self.conv_stem(x.to(self.dtype))))
        taps = []
        for stage in self.blocks:
            y = stage(y)
            taps.append(y)
        return [taps[0], taps[1], taps[2], taps[4], self.conv_head(y)]


class _OriginalModel(nn.Module):
    """Holds the trunk as ``original_model``, the reference's attribute."""

    def __init__(self, trunk: EfficientNet):
        super().__init__()
        self.original_model = trunk

    def forward(self, x):
        return self.original_model(x)


class BaseEncoderDecoder(nn.Module):
    """EfficientNet-B5 + DecoderBN (reference BaseEncoder.build,
    base_encoder.py:89-107): images [B,3,H,W] in [0,1] -> features
    [B,model_dim,H/2,W/2]."""

    def __init__(self, num_features: int = 2048, model_dim: int = 32, dtype=torch.float32):
        super().__init__()
        trunk = EfficientNet("efficientnet_b5", dtype=dtype)
        self.encoder = _OriginalModel(trunk)
        self.decoder = DecoderBN(num_features, model_dim, trunk.feature_channels, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        self.encoder.original_model.init_weights(generator)
        self.decoder.init_weights(generator)

    def forward(self, x):
        return self.decoder(self.encoder(x))
