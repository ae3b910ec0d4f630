"""Cityscapes datasets: preprocessed training triplets + raw eval frames.
The port's own copy of ``sfmnext_tpu/data/cityscapes.py``.

Behavioral reference:
  - CityscapesPreprocessedDataset (datasets/cityscapes_preprocessed_dataset.py:
    13-75): SfMLearner-preprocessed wide JPEGs (ego-car-cropped, 1024x384)
    split into [-1, 0, 1] frames; per-sequence K from <frame>_cam.txt
    normalized by RAW 1024x384.
  - CityscapesEvalDataset (datasets/cityscapes_evaldataset.py:15-104): raw
    leftImg8bit_sequence frames, bottom-25% ego-car crop, K from the
    camera JSON normalized by 2048 x (1024*0.75); previous frame at -2.
"""

from __future__ import annotations

import json
import os

import numpy as np

from sfmnext_tpu_torch.data.mono_dataset import MonoDataset, pil_image, pil_load


class CityscapesPreprocessedDataset(MonoDataset):
    RAW_WIDTH = 1024
    RAW_HEIGHT = 384

    def parse_line(self, line: str):
        city, frame_name = line.split()
        return city, frame_name, None

    def check_depth(self) -> bool:
        return False

    def intrinsics(self, folder=None, frame_index=None):
        cam_file = os.path.join(self.data_path, folder, f"{frame_index}_cam.txt")
        cam = np.loadtxt(cam_file, delimiter=",")
        K = np.array(
            [[cam[0], 0, cam[2], 0], [0, cam[4], cam[5], 0],
             [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float32,
        )
        K[0] *= self.width / self.RAW_WIDTH
        K[1] *= self.height / self.RAW_HEIGHT
        return K, np.linalg.inv(K).astype(np.float32)

    def __getitem__(self, index: int):
        city, frame_name, _ = self.parse_line(self.filenames[index])
        wide = np.asarray(
            pil_load(os.path.join(self.data_path, city, f"{frame_name}.jpg"))
        )
        w = wide.shape[1] // 3
        # wide image frame order is [-1, 0, 1] (reference :55-72)
        by_offset = {-1: wide[:, :w], 0: wide[:, w : 2 * w], 1: wide[:, 2 * w :]}
        Image = pil_image()
        frames = [
            self._resize(Image.fromarray(by_offset[f])) for f in self.frame_idxs
        ]
        K, inv_K = self.intrinsics(city, frame_name)
        return {"color": np.stack(frames, 0), "K": K, "inv_K": inv_K}


class CityscapesEvalDataset(MonoDataset):
    RAW_HEIGHT = 1024
    RAW_WIDTH = 2048

    def parse_line(self, line: str):
        city, frame_name = line.split()
        return city, frame_name, None

    def check_depth(self) -> bool:
        return False

    def intrinsics(self, folder=None, frame_index=None):
        cam_file = os.path.join(
            self.data_path, "camera_trainvaltest", "camera", "test", folder,
            frame_index + "_camera.json",
        )
        with open(cam_file) as f:
            cam = json.load(f)["intrinsic"]
        K = np.array(
            [[cam["fx"], 0, cam["u0"], 0], [0, cam["fy"], cam["v0"], 0],
             [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float32,
        )
        K[0] *= self.width / self.RAW_WIDTH
        K[1] *= self.height / (self.RAW_HEIGHT * 0.75)
        return K, np.linalg.inv(K).astype(np.float32)

    def _load_cropped(self, city, frame_name):
        path = os.path.join(
            self.data_path, "leftImg8bit_sequence", "test", city,
            frame_name + "_leftImg8bit.png",
        )
        img = pil_load(path)
        w, h = img.size
        return img.crop((0, 0, w, h * 3 // 4))  # drop ego-car bottom 25%

    @staticmethod
    def offset_frame(frame_name: str, offset: int) -> str:
        city, seq, num = frame_name.split("_")
        return f"{city}_{seq}_{int(num) + offset:06d}"

    def __getitem__(self, index: int):
        city, frame_name, _ = self.parse_line(self.filenames[index])
        frames = []
        for f in self.frame_idxs:
            name = frame_name if f == 0 else self.offset_frame(frame_name, -2)
            frames.append(self._resize(self._load_cropped(city, name)))
        K, inv_K = self.intrinsics(city, frame_name)
        return {"color": np.stack(frames, 0), "K": K, "inv_K": inv_K}
