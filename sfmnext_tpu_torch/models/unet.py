"""U-Net over a timm-style backbone (the reference's ``Unet``). Counterpart
of ``sfmnext_tpu/models/unet.py`` for its ``convnext_*`` branch.

The encoder's maps, deepest first, go through ``DecoderBlock``s of
[bilinear resize to the skip (align_corners=True), concat, 2x
(Conv3x3 without bias - BatchNorm - ReLU)]; the block after the last skip
doubles the map (align_corners=False); a 1x1 conv gives ``num_classes``
channels. With a ConvNeXt's four maps and four decoder blocks the output
lies at 1/2 of the input's resolution, where the SQL decoder expects it.
Parameter names are the reference's (``encoder.*`` timm, ``decoder.blocks.
<i>.conv<j>.{conv,bn}``, ``decoder.final_conv``). The JAX package's other
Unet backbone families are not ported yet and raise.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from sfmnext_tpu_torch.models.common import BatchNorm2d, kaiming_normal_fanout_
from sfmnext_tpu_torch.models.convnext import ConvNeXt, convnext_cfg
from sfmnext_tpu_torch.ops.image import resize_bilinear


class Conv2dBnAct(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, 3, padding=1, bias=False)
        self.bn = BatchNorm2d(features)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, skip: int, features: int):
        super().__init__()
        self.conv1 = Conv2dBnAct(cin + skip, features)
        self.conv2 = Conv2dBnAct(features, features)

    def forward(self, x, skip=None):
        if skip is not None:
            x = resize_bilinear(x, skip.shape[-2:], align_corners=True)
            x = torch.cat([x, skip.to(x.dtype)], dim=1)
        else:
            x = resize_bilinear(x, (2 * x.shape[-2], 2 * x.shape[-1]), align_corners=False)
        return self.conv2(self.conv1(x))


class UnetDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (1024, 512, 256, 128),
                 final_channels: int = 32):
        super().__init__()
        deepest_first = list(encoder_channels)[::-1]
        skips = deepest_first[1:]
        cin = deepest_first[0]
        blocks = []
        for i, ch in enumerate(decoder_channels):
            blocks.append(DecoderBlock(cin, skips[i] if i < len(skips) else 0, ch))
            cin = ch
        self.blocks = nn.ModuleList(blocks)
        self.final_conv = nn.Conv2d(cin, final_channels, 1)

    def forward(self, feats_deepest_first):
        x = feats_deepest_first[0]
        skips = feats_deepest_first[1:]
        for i, block in enumerate(self.blocks):
            x = block(x, skips[i] if i < len(skips) else None)
        return self.final_conv(x)


class Unet(nn.Module):
    """Images [B,3,H,W] in [0,1] -> features [B,num_classes,H/2,W/2]
    (float32 in a bf16 model, as the JAX ``Unet`` returns them)."""

    def __init__(self, backbone: str = "convnext_large", num_classes: int = 32,
                 decoder_channels: Sequence[int] = (1024, 512, 256, 128), dtype=torch.float32):
        super().__init__()
        if not backbone.startswith("convnext"):
            raise NotImplementedError(
                f"Unet backbone {backbone!r}: the port builds convnext_* only; the rest of "
                "the Unet zoo is ROADMAP.md queue 1 item 12")
        depths, dims = convnext_cfg(backbone)
        self.encoder = ConvNeXt(depths, dims, dtype=dtype)
        self.decoder = UnetDecoder(dims, decoder_channels, num_classes)
        self.to(dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The encoder's init, then the decoder's: kaiming_normal_fanout
        convs, zero final bias, BatchNorm 1 / 0."""
        self.encoder.init_weights(generator)
        for m in self.decoder.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_normal_fanout_(m.weight, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def forward(self, x):
        out = self.decoder(self.encoder(x)[::-1])
        return out.float()
