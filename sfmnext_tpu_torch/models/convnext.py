"""ConvNeXt feature encoder (timm ``convnext_*``). Counterpart of
``sfmnext_tpu/models/convnext.py``.

Stem 4x4 stride-4 conv + LayerNorm; four stages of blocks [depthwise 7x7
-> LayerNorm -> Linear 4x -> exact GELU -> Linear -> layer scale
``gamma``] with a residual; between stages LayerNorm + 2x2 stride-2 conv.
LayerNorms normalise the channels with eps 1e-6. Four maps at strides
4/8/16/32 with the stage widths, NCHW. Parameter names are timm's
(``stem.0``, ``stages.<i>.downsample.<j>``, ``stages.<i>.blocks.<j>.
{dwconv,norm,pwconv1,pwconv2,gamma}``), as the reference's ``Unet``
stores them under ``encoder.``.

The encoder runs channels-last: the block's LayerNorm and Linear layers
see its NHWC view without a copy, and cuDNN's bf16 depthwise 7x7 at
ConvNeXt-L's training batch runs 4.3-4.7x faster (forward and backward)
at the first three stages' maps than in NCHW memory (``chip_smoke.py``'s
``[convnext]`` lines; the last stage's is slower, PERF.md).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sfmnext_tpu_torch.models.common import lecun_normal_

CONVNEXT_CFGS = {
    "convnext_atto": ((2, 2, 6, 2), (40, 80, 160, 320)),
    "convnext_femto": ((2, 2, 6, 2), (48, 96, 192, 384)),
    "convnext_pico": ((2, 2, 6, 2), (64, 128, 256, 512)),
    "convnext_nano": ((2, 2, 8, 2), (80, 160, 320, 640)),
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    "convnext_xlarge": ((3, 3, 27, 3), (256, 512, 1024, 2048)),
}
LN_EPS = 1e-6
LAYER_SCALE_INIT = 1e-6


def convnext_cfg(name: str) -> Tuple[Sequence[int], Sequence[int]]:
    """(depths, dims) of a timm name, its pretrained tag (``.fb_in22k``) or
    suffix (``convnext_large_in22k``) ignored."""
    base = name.split(".")[0]
    for key in (base, "_".join(base.split("_")[:2])):
        if key in CONVNEXT_CFGS:
            return CONVNEXT_CFGS[key]
    raise ValueError(f"unknown convnext variant {name!r}")


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map: flax's ``nn.LayerNorm``
    on the last axis of its NHWC layout. On a channels-last tensor the
    permutes are views."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        y = self.dwconv(x).permute(0, 2, 3, 1)  # NHWC: the channels last
        y = self.pwconv2(F.gelu(self.pwconv1(self.norm(y)), approximate="none"))
        return x + (y * self.gamma.to(y.dtype)).permute(0, 3, 1, 2)


class ConvNeXtStage(nn.Module):
    def __init__(self, cin: int, dim: int, depth: int):
        super().__init__()
        if cin != dim:  # every stage but the first halves the map
            self.downsample = nn.Sequential(LayerNorm2d(cin, eps=LN_EPS),
                                            nn.Conv2d(cin, dim, 2, 2))
        else:
            self.downsample = None
        self.blocks = nn.Sequential(*(ConvNeXtBlock(dim) for _ in range(depth)))

    def forward(self, x):
        if self.downsample is not None:
            x = self.downsample(x)
        return self.blocks(x)


class ConvNeXt(nn.Module):
    """features_only encoder: images [B,3,H,W] (no normalisation, as the
    JAX package feeds them) -> 4 maps at strides 4/8/16/32."""

    def __init__(self, depths: Sequence[int] = (3, 3, 27, 3),
                 dims: Sequence[int] = (192, 384, 768, 1536), dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem = nn.Sequential(nn.Conv2d(3, dims[0], 4, 4), LayerNorm2d(dims[0], eps=LN_EPS))
        self.stages = nn.ModuleList(
            ConvNeXtStage(dims[max(i - 1, 0)], dim, depth)
            for i, (depth, dim) in enumerate(zip(depths, dims)))
        self.to(dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's defaults (lecun_normal kernels, zero biases, LayerNorm
        1 / 0) and the layer scale at 1e-6, as the JAX package's init."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, ConvNeXtBlock):
                m.gamma.fill_(LAYER_SCALE_INIT)

    def forward(self, x) -> List[torch.Tensor]:
        y = self.stem(x.to(self.dtype).contiguous(memory_format=torch.channels_last))
        feats = []
        for stage in self.stages:
            y = stage(y)
            feats.append(y)
        return feats
