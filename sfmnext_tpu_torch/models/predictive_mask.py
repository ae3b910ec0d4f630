"""PredictiveMask: the explainability mask of Zhou et al. (the
``--predictive_mask`` ablation). Counterpart of
``sfmnext_tpu/models/predictive_mask.py`` (reference
networks/predictive_mask.py).

A monodepth2-style upsampling decoder over the five-level ResNet pyramid:
at each level i from 4 down to 0, a ``ConvBlock`` (reflection pad 1, 3x3
convolution, ELU), a nearest x2 upsample, the concatenated skip (level
i-1, for i > 0) and a second ``ConvBlock``; at each of ``scales`` a
reflection-padded 3x3 convolution to one channel a source frame and a
sigmoid. Level 0 ends at the input's resolution.

State-dict names follow monodepth2's ``networks/depth_decoder.py``, whose
layout the reference's decoder copies: the blocks ``upconv_4_0``,
``upconv_4_1``, .., ``upconv_0_1`` and then the heads, registered in that
order in an ``nn.ModuleList`` ``decoder``, each block's convolution under
``conv.conv``, each head's under ``conv``.

The JAX module declares no dtype, so it runs in float32 whatever the
compute dtype, and so does this one (autocast off, inputs cast up).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from sfmnext_tpu_torch.models.common import torch_default_init_

NUM_CH_DEC = (16, 32, 64, 128, 256)


class Conv3x3(nn.Module):
    """Reflection pad 1 and a 3x3 convolution."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3)

    def forward(self, x):
        return self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))


class ConvBlock(nn.Module):
    """``Conv3x3`` then ELU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv3x3(cin, cout)

    def forward(self, x):
        return F.elu(self.conv(x))


class PredictiveMask(nn.Module):
    """The pyramid [x0..x4] (NCHW, x0 at 1/2 resolution) ->
    {("disp", s): [B,num_output_channels,H/2^s,W/2^s] in (0, 1)} float32."""

    def __init__(self, num_ch_enc: Sequence[int], num_output_channels: int = 2,
                 scales: Sequence[int] = (0,)):
        super().__init__()
        self.scales = tuple(scales)
        blocks = []
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else NUM_CH_DEC[i + 1]
            blocks.append(ConvBlock(cin, NUM_CH_DEC[i]))
            skip = num_ch_enc[i - 1] if i > 0 else 0
            blocks.append(ConvBlock(NUM_CH_DEC[i] + skip, NUM_CH_DEC[i]))
        heads = [Conv3x3(NUM_CH_DEC[s], num_output_channels) for s in self.scales]
        self.decoder = nn.ModuleList(blocks + heads)

    def init_weights(self, generator: torch.Generator) -> None:
        torch_default_init_(self, generator)

    def forward(self, input_features) -> Dict:
        outputs = {}
        heads = dict(zip(self.scales, self.decoder[10:]))
        with torch.autocast(input_features[-1].device.type, enabled=False):
            x = input_features[-1].float()
            for j, i in enumerate(range(4, -1, -1)):
                x = F.interpolate(self.decoder[2 * j](x), scale_factor=2, mode="nearest")
                if i > 0:
                    x = torch.cat([x, input_features[i - 1].float()], dim=1)
                x = self.decoder[2 * j + 1](x)
                if i in heads:
                    outputs[("disp", i)] = torch.sigmoid(heads[i](x))
        return outputs
