"""NYU-Depth-v2 raw indoor video dataset (SSL training). The port's own
copy of ``sfmnext_tpu/data/nyu.py``.

Behavioral reference: datasets/nyu_raw_dataset.py:12-67 +
datasets/mono_dataset_nyu.py — fixed normalized K
[[0.8107,0,0.5087],[0,1.0822,0.5286]], frames named <idx>.<ext> directly in
the sequence folder, horizontal flip disabled (indoor principal point is
off-center, nyu_raw_dataset.py:50-52; the train step reads the same rule
from ``--dataset``, ``training/step.py``), no GT during SSL, and an extra
``K3x3`` intrinsics entry for RectifyNet (mono_dataset_nyu.py:161-172).
"""

from __future__ import annotations

import os

import numpy as np

from sfmnext_tpu_torch.data.mono_dataset import MonoDataset, pil_load


class NYURawDataset(MonoDataset):
    K = np.array(
        [[0.8107, 0, 0.5087, 0], [0, 1.0822, 0.5286, 0],
         [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float32,
    )
    full_res_shape = (640, 480)
    allow_flip = False  # off-center principal point

    def check_depth(self) -> bool:
        return False

    def get_color(self, folder, frame_index, side):
        path = os.path.join(
            self.data_path, folder, f"{frame_index:010d}{self.img_ext}"
        )
        return pil_load(path)

    def __getitem__(self, index: int):
        item = super().__getitem__(index)
        K, _ = self.intrinsics()
        item["K3x3"] = K[:3, :3].copy()  # RectifyNet warp intrinsics
        return item
