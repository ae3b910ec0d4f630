"""BTS-style supervised depth data. The port's own copy of
``sfmnext_tpu/finetune/dataloader.py``.

Behavioral reference: finetune/dataloader.py:28-288 —
  - filenames_file lines: "<image> <depth> <focal>"
  - KITTI: kb-crop to 352x1216 (bottom-center), depth png / 256
  - NYU: crop depth/image margins, depth png / 1000
  - train augs: random rotate (+-degree), random crop to
    (input_height, input_width), 50% flip, 50% gamma/brightness/color
  - 'has_valid_depth' skip flag for missing GT

Every draw comes from one ``random.Random(seed)`` in the JAX class's order,
so the same seed and the same order of item reads give the JAX items. PIL
is imported where a file is decoded (``data/mono_dataset.pil_image``): the
card's machine has none and is fed decoded items.
"""

from __future__ import annotations

import os
import random

import numpy as np

from sfmnext_tpu_torch.data.mono_dataset import pil_image

KB_CROP_HW = (352, 1216)
NYU_MARGIN_BOX = (43, 45, 608, 472)  # (left, top, right, bottom)


def _open(path: str):
    """The file at ``path`` as a loaded ``PIL.Image`` (its mode kept)."""
    img = pil_image().open(path)
    img.load()
    return img


class DepthDataset:
    """Items: {'image' [H,W,3] f32, 'depth' [H,W,1] f32 (meters),
    'focal' scalar, 'has_valid_depth' bool}."""

    def __init__(self, data_path: str, gt_path: str, filenames_file: str, mode: str = "train",
                 dataset: str = "kitti", input_height: int = 352, input_width: int = 1216,
                 do_kb_crop: bool = True, degree: float = 1.0, seed: int = 0):
        with open(filenames_file) as f:
            self.frames = [ln.split() for ln in f if ln.strip()]
        self.data_path = data_path
        self.gt_path = gt_path
        self.mode = mode
        self.dataset = dataset
        self.h, self.w = input_height, input_width
        self.do_kb_crop = do_kb_crop
        self.degree = degree
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.frames)

    def _load_pair(self, rec):
        focal = float(rec[2]) if len(rec) > 2 else 721.5377
        image = _open(os.path.join(self.data_path, rec[0])).convert("RGB")
        depth_path = os.path.join(self.gt_path, rec[1])
        if not os.path.exists(depth_path):
            return image, None, focal
        return image, _open(depth_path), focal

    def __getitem__(self, index):
        image, depth, focal = self._load_pair(self.frames[index])
        if depth is None:
            # the reference skips these in its loop (train_ft_SQLdepth.py:227-229)
            return {
                "image": np.zeros((self.h, self.w, 3), np.float32),
                "depth": np.zeros((self.h, self.w, 1), np.float32),
                "focal": np.float32(focal),
                "has_valid_depth": np.asarray(False),
            }

        if self.do_kb_crop and self.dataset == "kitti":
            # bottom-centre 352x1216, skipped for a frame smaller than the crop
            w, h = image.size
            kh, kw = KB_CROP_HW
            if w >= kw and h >= kh:
                top, left = h - kh, (w - kw) // 2
                image = image.crop((left, top, left + kw, top + kh))
                depth = depth.crop((left, top, left + kw, top + kh))

        Image = pil_image()
        if self.dataset == "nyu" and self.mode == "train":
            # margin crop off the blank registration borders, then the input
            # size forced on the image; depth keeps the crop's 565x427
            # (reference dataloader.py:109-112)
            w, h = image.size
            if w >= NYU_MARGIN_BOX[2] and h >= NYU_MARGIN_BOX[3]:
                image = image.crop(NYU_MARGIN_BOX)
                depth = depth.crop(NYU_MARGIN_BOX)
            image = image.resize((self.w, self.h), Image.Resampling.BILINEAR)

        scale = 256.0 if self.dataset == "kitti" else 1000.0
        if self.mode == "train":
            if self.degree > 0:
                angle = self.rng.uniform(-self.degree, self.degree)
                image = image.rotate(angle, resample=Image.Resampling.BILINEAR)
                depth = depth.rotate(angle, resample=Image.Resampling.NEAREST)
            img = np.asarray(image, np.float32) / 255.0
            dep = np.asarray(depth, np.float32) / scale
            if self.dataset != "nyu":  # NYU's shapes are already fixed (its crop is off)
                img, dep = self._random_crop(img, dep)
            if self.rng.random() > 0.5:
                img, dep = img[:, ::-1].copy(), dep[:, ::-1].copy()
            if self.rng.random() > 0.5:
                img = self._augment_color(img)
        else:
            img = np.asarray(image, np.float32) / 255.0
            dep = np.asarray(depth, np.float32) / scale

        return {
            "image": img.astype(np.float32),
            "depth": dep[..., None].astype(np.float32),
            "focal": np.float32(focal),
            "has_valid_depth": np.asarray(True),
        }

    def _random_crop(self, img, dep):
        h, w = img.shape[:2]
        if h <= self.h or w <= self.w:
            return img[:self.h, :self.w], dep[:self.h, :self.w]
        y = self.rng.randint(0, h - self.h)
        x = self.rng.randint(0, w - self.w)
        return img[y:y + self.h, x:x + self.w], dep[y:y + self.h, x:x + self.w]

    def _augment_color(self, img):
        """Gamma, brightness and a per-channel colour (reference
        train_preprocess), clipped to [0, 1]."""
        img = img ** self.rng.uniform(0.9, 1.1)
        img = img * self.rng.uniform(0.9, 1.1)
        colors = np.asarray([self.rng.uniform(0.9, 1.1) for _ in range(3)], np.float32)
        return np.clip(img * colors[None, None, :], 0, 1)
