"""Host-side dataset: file lists -> decoded, resized numpy frame stacks.
The port's own copy of ``sfmnext_tpu/data/mono_dataset.py``.

Behavioral reference: datasets/mono_dataset.py:28-210 (MonoDataset):
PIL decode and LANCZOS resize on host threads; the flip and ColorJitter
run on the card (``data/augment.py``); one scale; K scaled once and
inverted on the host.

Items are dicts of numpy arrays:
  'color' [F,H,W,3] float32 in [0,1] (frame order = frame_idxs),
  'K'/'inv_K' [4,4], optional 'depth_gt' [H,W,1], 'stereo_T' [4,4].

PIL is imported by the functions that decode, not by the module: the
evaluation and the card's smoke script import the datasets on a machine
without PIL and feed decoded frames themselves.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def pil_image():
    """PIL's ``Image`` module; an ImportError naming PIL where it is absent."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("decoding and resizing dataset images needs PIL (Pillow), "
                          "which is not installed") from e
    return Image


def read_lines(path: str) -> List[str]:
    with open(path, "r") as f:
        return [ln.strip() for ln in f if ln.strip()]


def pil_load(path: str):
    """The image at ``path`` as an RGB ``PIL.Image``."""
    Image = pil_image()
    with open(path, "rb") as f:
        with Image.open(f) as img:
            return img.convert("RGB")


class MonoDataset:
    """Base class; subclasses implement get_color / get_depth / K."""

    # normalized intrinsics [4,4]; subclasses override
    K = np.eye(4, dtype=np.float32)
    full_res_shape = (1242, 375)  # (W, H)

    def __init__(
        self,
        data_path: str,
        filenames: Sequence[str],
        height: int,
        width: int,
        frame_idxs: Sequence,
        is_train: bool = False,
        img_ext: str = ".png",
        load_depth: Optional[bool] = None,
    ):
        self.data_path = data_path
        self.filenames = list(filenames)
        self.height = height
        self.width = width
        self.frame_idxs = list(frame_idxs)
        self.is_train = is_train
        self.img_ext = img_ext
        self.load_depth = (
            self.check_depth() if load_depth is None else load_depth
        )

    def __len__(self):
        return len(self.filenames)

    # -- per-dataset hooks -------------------------------------------------
    def check_depth(self) -> bool:
        return False

    def get_color(self, folder, frame_index, side):
        raise NotImplementedError

    def get_depth(self, folder, frame_index, side) -> np.ndarray:
        raise NotImplementedError

    def parse_line(self, line: str):
        parts = line.split()
        folder = parts[0]
        frame_index = int(parts[1]) if len(parts) >= 2 else 0
        side = parts[2] if len(parts) >= 3 else None
        return folder, frame_index, side

    def intrinsics(self, folder=None, frame_index=None):
        """Pixel-scaled K at the training resolution (+ its inverse)."""
        K = self.K.copy()
        K[0] *= self.width
        K[1] *= self.height
        return K, np.linalg.inv(K).astype(np.float32)

    # -- item assembly -----------------------------------------------------
    def _resize(self, img) -> np.ndarray:
        img = img.resize((self.width, self.height), pil_image().LANCZOS)
        return np.asarray(img, dtype=np.float32) / 255.0

    def __getitem__(self, index: int):
        folder, frame_index, side = self.parse_line(self.filenames[index])

        frames = []
        for f in self.frame_idxs:
            if f == "s":
                other = {"r": "l", "l": "r"}[side]
                img = self.get_color(folder, frame_index, other)
            else:
                img = self.get_color(folder, frame_index + f, side)
            frames.append(self._resize(img))

        K, inv_K = self.intrinsics(folder, frame_index)
        item = {
            "color": np.stack(frames, 0),
            "K": K,
            "inv_K": inv_K,
        }
        if self.load_depth and side is not None:
            depth = self.get_depth(folder, frame_index, side)
            item["depth_gt"] = depth[..., None].astype(np.float32)
        if "s" in self.frame_idxs:
            stereo_T = np.eye(4, dtype=np.float32)
            side_sign = -1 if side == "l" else 1
            stereo_T[0, 3] = side_sign * 0.1  # flip sign applied on device
            item["stereo_T"] = stereo_T
        return item
