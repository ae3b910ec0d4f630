"""BN U-decoder over the ResNet pyramid + the combined encoder-decoders.

Counterpart of ``sfmnext_tpu/models/decoder_bn.py`` (UpSampleBN, DecoderBN,
ResnetEncoderDecoder, and the paper's Lite model LiteResnetEncoderDecoder:
ResNet-18 and DecoderBN(256)), with the reference's state-dict names
(``decoder.up1._net.0``, ...). The reference quirk is kept: the bottleneck
1x1 ``conv2`` has padding 1, so it sees a zero ring around the 1/32 map.
Output: ``model_dim`` channels at 1/2 input resolution, NCHW.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from sfmnext_tpu_torch.models.common import BatchNorm2d, torch_default_init_
from sfmnext_tpu_torch.models.resnet import ResNetEncoder
from sfmnext_tpu_torch.ops.image import resize_bilinear


class UpSampleBN(nn.Module):
    """Bilinear-upsample to the skip's size, concat, 2x (Conv3x3-BN-LeakyReLU)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self._net = nn.Sequential(
            nn.Conv2d(cin, features, 3, 1, 1), BatchNorm2d(features),
            nn.LeakyReLU(0.01),
            nn.Conv2d(features, features, 3, 1, 1), BatchNorm2d(features),
            nn.LeakyReLU(0.01),
        )

    def forward(self, x, skip):
        up = resize_bilinear(x, skip.shape[-2:], align_corners=True)
        return self._net(torch.cat([up, skip.to(up.dtype)], dim=1))


class DecoderBN(nn.Module):
    """4-stage BN upsample decoder: 1/32 -> 1/2 resolution, model_dim chans."""

    def __init__(self, num_features: int = 512, model_dim: int = 32,
                 skip_channels: Sequence[int] = (64, 256, 512, 1024, 2048),
                 dtype=torch.float32):
        super().__init__()
        f = num_features
        c0, c1, c2, c3, c4 = skip_channels
        self.conv2 = nn.Conv2d(c4, f, 1, 1, padding=1)
        self.up1 = UpSampleBN(f + c3, f // 2)
        self.up2 = UpSampleBN(f // 2 + c2, f // 4)
        self.up3 = UpSampleBN(f // 4 + c1, f // 8)
        self.up4 = UpSampleBN(f // 8 + c0, f // 16)
        self.conv3 = nn.Conv2d(f // 16, model_dim, 3, 1, 1)
        self.to(dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        torch_default_init_(self, generator)

    def forward(self, features):
        x0, x1, x2, x3, x4 = features
        y = self.conv2(x4)
        y = self.up1(y, x3)
        y = self.up2(y, x2)
        y = self.up3(y, x1)
        y = self.up4(y, x0)
        return self.conv3(y)


class ResnetEncoderDecoder(nn.Module):
    """ResNet pyramid + DecoderBN: images [B,3,H,W] in [0,1] ->
    features [B,model_dim,H/2,W/2]."""

    def __init__(self, num_layers: int = 50, num_features: int = 512,
                 model_dim: int = 32, dtype=torch.float32):
        super().__init__()
        self.encoder = ResNetEncoder(num_layers, dtype=dtype)
        self.decoder = DecoderBN(
            num_features, model_dim, ResNetEncoder.feature_channels(num_layers),
            dtype=dtype,
        )

    def init_weights(self, generator: torch.Generator) -> None:
        self.encoder.init_weights(generator)
        self.decoder.init_weights(generator)

    def forward(self, x, return_pyramid: bool = False):
        """``return_pyramid``: (features, the encoder's five maps), for the
        predictive mask (reference trainer.py:290-291)."""
        pyramid = self.encoder(x)
        out = self.decoder(pyramid)
        return (out, pyramid) if return_pyramid else out


class LiteResnetEncoderDecoder(ResnetEncoderDecoder):
    """ResNet-18 + the slim DecoderBN(256) (reference
    networks/lite_res_encoder.py:148-157); the same state-dict names."""

    def __init__(self, model_dim: int = 128, dtype=torch.float32):
        super().__init__(18, 256, model_dim, dtype=dtype)
