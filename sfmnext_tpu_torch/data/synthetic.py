"""Synthetic ego-motion dataset for tests and benchmarks.

The port's own copy of ``sfmnext_tpu/data/synthetic.py`` (numpy only): the
same seed gives the same batch. Renders a textured fronto-parallel "scene" with per-pixel depth and
translates the camera between frames so the photometric objective is
actually informative (warping the neighbor frame with the true depth and
pose reconstructs the target frame). Replaces no reference component —
the reference has no tests (SURVEY.md §4); this is our fixture.
"""

from __future__ import annotations

import numpy as np

KITTI_NORMALIZED_K = np.array(
    [[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
    dtype=np.float32,
)  # reference kitti_dataset.py:29-32


def _texture(rng, h, w):
    """Random RGB texture in [0,1]: low-frequency base + fine detail.

    The fine detail matters — a too-smooth texture gives the photometric
    loss almost no gradient signal for depth."""
    small = rng.rand(h // 8 + 2, w // 8 + 2, 3).astype(np.float32)
    img = np.kron(small, np.ones((8, 8, 1), np.float32))[:h, :w]
    for _ in range(2):
        img = (
            img
            + np.roll(img, 1, 0)
            + np.roll(img, -1, 0)
            + np.roll(img, 1, 1)
            + np.roll(img, -1, 1)
        ) / 5.0
    detail = rng.rand(h, w, 1).astype(np.float32)
    return np.clip(0.75 * img + 0.25 * detail, 0.0, 1.0)


class SyntheticDriveDataset:
    """Batches shaped like the real pipeline output.

    Keys: 'color', 'color_aug' [B,F,H,W,3] (F = frame_ids order),
    'K', 'inv_K' [B,4,4], 'depth_gt' [B,H,W,1].
    """

    def __init__(self, height=64, width=96, frame_ids=(0, -1, 1), seed=0,
                 with_depth_gt=True):
        self.h, self.w = height, width
        self.frame_ids = frame_ids
        self.rng = np.random.RandomState(seed)
        self.with_depth_gt = with_depth_gt
        K = KITTI_NORMALIZED_K.copy()
        K[0] *= width
        K[1] *= height
        self.K = K
        self.inv_K = np.linalg.inv(K).astype(np.float32)

    def _scene(self):
        h, w = self.h, self.w
        tex = _texture(self.rng, h, w)
        # depth: horizontal gradient plane + random boxes ("cars")
        depth = 10.0 + 20.0 * np.linspace(0, 1, h)[::-1, None] ** 2
        depth = np.broadcast_to(depth, (h, w)).copy()
        for _ in range(3):
            y, x = self.rng.randint(0, h - 8), self.rng.randint(0, w - 12)
            depth[y : y + 8, x : x + 12] = self.rng.uniform(4, 9)
        return tex, depth.astype(np.float32)

    def _render(self, tex, depth, tx):
        """Render the scene from a camera shifted by tx along +x (stereo-like).

        Inverse warp with true depth: sample source pixel x' = x - fx*tx/Z.
        """
        h, w = self.h, self.w
        fx = self.K[0, 0]
        xs = np.arange(w)[None, :].repeat(h, 0).astype(np.float32)
        shift = fx * tx / depth
        src_x = np.clip(xs - shift, 0, w - 1)
        x0 = np.floor(src_x).astype(np.int32)
        x1 = np.minimum(x0 + 1, w - 1)
        a = (src_x - x0)[..., None]
        rows = np.arange(h)[:, None]
        return tex[rows, x0] * (1 - a) + tex[rows, x1] * a

    def batch(self, batch_size: int):
        F = len(self.frame_ids)
        color = np.zeros((batch_size, F, self.h, self.w, 3), np.float32)
        depth_gt = np.zeros((batch_size, self.h, self.w, 1), np.float32)
        for b in range(batch_size):
            tex, depth = self._scene()
            speed = self.rng.uniform(0.2, 0.5)
            for fi, f in enumerate(self.frame_ids):
                color[b, fi] = self._render(tex, depth, tx=speed * f)
            depth_gt[b, :, :, 0] = depth
        out = {
            "color": color,
            "color_aug": color.copy(),
            "K": np.broadcast_to(self.K, (batch_size, 4, 4)).copy(),
            "inv_K": np.broadcast_to(self.inv_K, (batch_size, 4, 4)).copy(),
        }
        if self.with_depth_gt:
            out["depth_gt"] = depth_gt
        return out


def make_batch(batch_size=2, height=64, width=96, frame_ids=(0, -1, 1), seed=0):
    return SyntheticDriveDataset(height, width, frame_ids, seed).batch(batch_size)
