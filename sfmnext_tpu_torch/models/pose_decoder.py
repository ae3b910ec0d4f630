"""PoseDecoder: 6-DoF poses from encoder features. Counterpart of
``sfmnext_tpu/models/pose_decoder.py`` (reference networks/pose_decoder.py).

One 1x1 squeeze to 256 with ReLU, shared by every input and applied to the
deepest map of each, the squeezed maps concatenated, two 3x3 convolutions
with ReLU and a 1x1 convolution to 6 * n_frames, the spatial mean, scaled
by 0.01 and split into (axisangle, translation).

State-dict names follow monodepth2's ``networks/pose_decoder.py``, which
the reference's copy keeps: the convolutions ``squeeze``, ``pose_0``,
``pose_1`` and ``pose_2`` registered in that order in an ``nn.ModuleList``
``net`` (``net.0`` .. ``net.3``).

The JAX module declares no dtype, so flax promotes its bf16 inputs to its
float32 parameters: it runs in float32 whatever the compute dtype, and so
does this one (autocast off, inputs cast up).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from sfmnext_tpu_torch.models.common import torch_default_init_


class PoseDecoder(nn.Module):
    """A list of ``num_input_features`` feature pyramids (each a list of
    NCHW maps; only the last is read) -> (axisangle, translation), each
    [B,n_frames,1,3] float32.

    Args:
      num_ch_enc: channels of the deepest map of each input.
      num_input_features: the inputs, whose squeezed maps are concatenated.
      num_frames_to_predict_for: n_frames; ``num_input_features - 1`` if None.
    """

    def __init__(self, num_ch_enc: int, num_input_features: int = 1,
                 num_frames_to_predict_for: Optional[int] = None):
        super().__init__()
        if num_frames_to_predict_for is None:
            num_frames_to_predict_for = num_input_features - 1
        self.n_frames = num_frames_to_predict_for
        self.net = nn.ModuleList([
            nn.Conv2d(num_ch_enc, 256, 1),                       # squeeze
            nn.Conv2d(num_input_features * 256, 256, 3, 1, 1),   # pose_0
            nn.Conv2d(256, 256, 3, 1, 1),                        # pose_1
            nn.Conv2d(256, 6 * num_frames_to_predict_for, 1),    # pose_2
        ])

    def init_weights(self, generator: torch.Generator) -> None:
        torch_default_init_(self, generator)

    def forward(self, input_features: Sequence[Sequence[torch.Tensor]]):
        last = [f[-1] for f in input_features]
        with torch.autocast(last[0].device.type, enabled=False):
            squeeze, pose_0, pose_1, pose_2 = self.net
            y = torch.cat([F.relu(squeeze(f.float())) for f in last], dim=1)
            y = F.relu(pose_0(y))
            y = F.relu(pose_1(y))
            y = 0.01 * pose_2(y).mean(dim=(2, 3)).reshape(-1, self.n_frames, 1, 6)
        return y[..., :3], y[..., 3:]
