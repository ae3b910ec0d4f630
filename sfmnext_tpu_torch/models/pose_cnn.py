"""PoseCNN: 6-DoF ego-motion from a stacked frame pair. Counterpart of
``sfmnext_tpu/models/pose_cnn.py`` (reference networks/pose_cnn.py:8-45).

Seven strided convolutions (16, 32, 64, 128, 256, 256, 256) with ReLU, a
1x1 convolution to 6*(n-1), the spatial mean, scaled by 0.01 and split
into (axisangle, translation). Plain strided ``nn.Conv2d``s: the JAX
package's space-to-depth rewrite of the two large stride-2 convolutions
is a TPU layout device with the same weights and output. State-dict
names are the reference's (``net.<i>``, ``pose_conv``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from sfmnext_tpu_torch.models.common import torch_default_init_

# (out channels, kernel, stride, padding)
SPECS = ((16, 7, 2, 3), (32, 5, 2, 2), (64, 3, 2, 1), (128, 3, 2, 1),
         (256, 3, 2, 1), (256, 3, 2, 1), (256, 3, 2, 1))


class PoseCNN(nn.Module):
    """Frames stacked on channels [B,3n,H,W] -> (axisangle, translation),
    each [B,n-1,1,3] float32."""

    def __init__(self, num_input_frames: int = 2, dtype=torch.float32):
        super().__init__()
        self.num_input_frames = num_input_frames
        self.dtype = dtype
        cin, convs = 3 * num_input_frames, []
        for cout, k, s, p in SPECS:
            convs.append(nn.Conv2d(cin, cout, k, s, p))
            cin = cout
        self.net = nn.ModuleList(convs)
        self.pose_conv = nn.Conv2d(cin, 6 * (num_input_frames - 1), 1)
        self.to(dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        torch_default_init_(self, generator)

    def forward(self, x: torch.Tensor):
        y = x.to(self.dtype)
        for conv in self.net:
            y = F.relu(conv(y))
        # the pose leaves in float32: 0.01-scale outputs feed SE(3) math
        y = self.pose_conv(y).float().mean(dim=(2, 3))
        y = 0.01 * y.reshape(-1, self.num_input_frames - 1, 1, 6)
        return y[..., :3], y[..., 3:]
