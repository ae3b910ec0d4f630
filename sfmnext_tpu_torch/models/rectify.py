"""RectifyNet: a 3-DoF rotation between two frames, for the indoor
pipeline's removal of camera shake. Counterpart of
``sfmnext_tpu/models/rectify.py`` (reference networks/rectify_net.py:6-68).

A ResNet-18 over the two frames stacked on channels at half resolution
(resized with align_corners=True), then ``RotDecoder``: a 1x1 squeeze to
256, two 3x3 convolutions and a 1x1 to 3, each but the last with ReLU,
the spatial mean, and the pitch (index 2) zeroed. State-dict names are the
reference's (``encoder.encoder.*``, ``decoder.conv_squeeze``,
``decoder.convs_pose.<i>``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sfmnext_tpu_torch.models.common import torch_default_init_
from sfmnext_tpu_torch.models.resnet import ResNetEncoder
from sfmnext_tpu_torch.ops.image import resize_bilinear


class RotDecoder(nn.Module):
    """The deepest ResNet feature map [B,C,h,w] -> Euler angles [B,3]
    float32, pitch zeroed."""

    def __init__(self, num_ch_enc: int = 512):
        super().__init__()
        self.conv_squeeze = nn.Conv2d(num_ch_enc, 256, 1)
        self.convs_pose = nn.ModuleList([
            nn.Conv2d(256, 256, 3, 1, 1), nn.Conv2d(256, 256, 3, 1, 1), nn.Conv2d(256, 3, 1),
        ])

    def forward(self, features):
        y = F.relu(self.conv_squeeze(features[-1]))
        y = F.relu(self.convs_pose[0](y))
        y = F.relu(self.convs_pose[1](y))
        # the rotation leaves in float32: it feeds the warp's geometry
        y = self.convs_pose[2](y).float().mean(dim=(2, 3))
        return y * torch.tensor([1.0, 1.0, 0.0], device=y.device)


class RectifyNet(nn.Module):
    """(img1, img2) [B,3,H,W] in [0,1] -> rotation [B,3] float32."""

    def __init__(self, num_layers: int = 18):
        super().__init__()
        self.encoder = ResNetEncoder(num_layers, num_input_images=2)
        self.decoder = RotDecoder(ResNetEncoder.feature_channels(num_layers)[-1])

    def init_weights(self, generator: torch.Generator) -> None:
        self.encoder.init_weights(generator)
        torch_default_init_(self.decoder, generator)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        x = torch.cat([img1, img2], dim=1)
        h, w = x.shape[-2:]
        x = resize_bilinear(x, (h // 2, w // 2), align_corners=True)
        return self.decoder(self.encoder(x))
