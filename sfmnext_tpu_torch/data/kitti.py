"""KITTI dataset family. The port's own copy of ``sfmnext_tpu/data/kitti.py``.

Behavioral reference: datasets/kitti_dataset.py:18-134 — normalized K
[[0.58,0,0.5],[0,1.92,0.5]] (:29-32), side map l->image_02 / r->image_03,
velodyne GT for KITTIRAW, png GT for KITTIDepth, sequence layout for
KITTIOdom.
"""

from __future__ import annotations

import os

import numpy as np

from sfmnext_tpu_torch.data.kitti_utils import generate_depth_map
from sfmnext_tpu_torch.data.mono_dataset import MonoDataset, pil_image, pil_load


def _resize_nearest_np(arr: np.ndarray, out_wh) -> np.ndarray:
    """Nearest-neighbor resize (skimage order=0 equivalent, no deps)."""
    ow, oh = out_wh
    h, w = arr.shape
    iy = (np.arange(oh) * h // oh).clip(0, h - 1)
    ix = (np.arange(ow) * w // ow).clip(0, w - 1)
    return arr[iy][:, ix]


class KITTIDataset(MonoDataset):
    K = np.array(
        [[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
        dtype=np.float32,
    )
    full_res_shape = (1242, 375)
    side_map = {"2": 2, "3": 3, "l": 2, "r": 3}

    def check_depth(self) -> bool:
        if not self.filenames:
            return False
        folder, frame_index, _ = self.parse_line(self.filenames[0])
        velo = os.path.join(
            self.data_path, folder,
            "velodyne_points/data/{:010d}.bin".format(frame_index),
        )
        return os.path.isfile(velo)

    def get_color(self, folder, frame_index, side):
        return pil_load(self.get_image_path(folder, frame_index, side))


class KITTIRAWDataset(KITTIDataset):
    """Raw KITTI with velodyne ground-truth depth."""

    def get_image_path(self, folder, frame_index, side):
        fname = "{:010d}{}".format(frame_index, self.img_ext)
        return os.path.join(
            self.data_path, folder,
            "image_0{}/data".format(self.side_map[side]), fname,
        )

    def get_depth(self, folder, frame_index, side):
        calib = os.path.join(self.data_path, folder.split("/")[0])
        velo = os.path.join(
            self.data_path, folder,
            "velodyne_points/data/{:010d}.bin".format(frame_index),
        )
        depth = generate_depth_map(calib, velo, self.side_map[side])
        return _resize_nearest_np(depth, self.full_res_shape).astype(np.float32)


class KITTIOdomDataset(KITTIDataset):
    """Odometry benchmark sequences."""

    def get_image_path(self, folder, frame_index, side):
        fname = "{:06d}{}".format(frame_index, self.img_ext)
        return os.path.join(
            self.data_path,
            "sequences/{:02d}".format(int(folder)),
            "image_{}".format(self.side_map[side]),
            fname,
        )


class KITTIDepthDataset(KITTIDataset):
    """KITTI with the improved (benchmark) png ground truth."""

    def get_image_path(self, folder, frame_index, side):
        fname = "{:010d}{}".format(frame_index, self.img_ext)
        return os.path.join(
            self.data_path, folder,
            "image_0{}/data".format(self.side_map[side]), fname,
        )

    def get_depth(self, folder, frame_index, side):
        Image = pil_image()
        fname = "{:010d}.png".format(frame_index)
        path = os.path.join(
            self.data_path, folder,
            "proj_depth/groundtruth/image_0{}".format(self.side_map[side]),
            fname,
        )
        img = Image.open(path).resize(self.full_res_shape, Image.NEAREST)
        return np.asarray(img).astype(np.float32) / 256.0
