"""MannequinChallenge indoor video dataset. The port's own copy of
``sfmnext_tpu/data/mannequin.py``.

Behavioral reference: datasets/mc_dataset.py:17-63 +
datasets/mono_dataset_mc.py — per-folder intrinsics read from
``splits/mc_dataset/KV_intrinsics.txt`` (lines: folder fx fy px py,
normalized), frames named <idx>.<ext> in the folder, no GT.
"""

from __future__ import annotations

import os

import numpy as np

from sfmnext_tpu_torch.data.mono_dataset import MonoDataset, pil_load


def load_intrinsics_map(path: str):
    table = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 5:
                continue
            folder, fx, fy, px, py = parts[0], *map(float, parts[1:5])
            K = np.array(
                [[fx, 0, px, 0], [0, fy, py, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                dtype=np.float32,
            )
            table[folder] = K
    return table


class MCDataset(MonoDataset):
    full_res_shape = (640, 360)
    allow_flip = True

    def __init__(self, *args, intrinsics_file=None, **kwargs):
        super().__init__(*args, **kwargs)
        if intrinsics_file is None:
            intrinsics_file = os.path.join(
                os.path.dirname(self.data_path), "KV_intrinsics.txt"
            )
        self.kv_intrinsics = (
            load_intrinsics_map(intrinsics_file)
            if os.path.exists(intrinsics_file)
            else {}
        )

    def check_depth(self) -> bool:
        return False

    def intrinsics(self, folder=None, frame_index=None):
        K = self.kv_intrinsics.get(folder)
        if K is None:
            K = np.array(
                [[0.9, 0, 0.5, 0], [0, 1.2, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                dtype=np.float32,
            )
        K = K.copy()
        K[0] *= self.width
        K[1] *= self.height
        return K, np.linalg.inv(K).astype(np.float32)

    def get_color(self, folder, frame_index, side):
        path = os.path.join(
            self.data_path, folder, f"{frame_index:010d}{self.img_ext}"
        )
        return pil_load(path)

    def __getitem__(self, index: int):
        item = super().__getitem__(index)
        folder, frame_index, _ = self.parse_line(self.filenames[index])
        K, _ = self.intrinsics(folder, frame_index)
        item["K3x3"] = K[:3, :3].copy()
        return item
