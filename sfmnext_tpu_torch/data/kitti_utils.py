"""KITTI calibration parsing and velodyne -> sparse depth projection. The
port's own copy of ``sfmnext_tpu/data/kitti_utils.py`` (numpy only).

Behavioral reference: kitti_utils.py:10-100 (same protocol:
rectified cam projection, round-minus-one pixel snap to match the KITTI
matlab code, min-depth resolution of duplicate pixels). Implementation is
vectorized numpy (the reference loops per duplicate; we use a sorted
scatter-min).
"""

from __future__ import annotations

import os

import numpy as np


def load_velodyne_points(path: str) -> np.ndarray:
    """[N,4] float32 (x fwd, y left, z up, reflectance->1 homogeneous)."""
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    pts[:, 3] = 1.0
    return pts


def read_calib_file(path: str) -> dict:
    """KITTI calib txt -> {key: float array | str}."""
    out = {}
    with open(path, "r") as f:
        for line in f:
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            value = value.strip()
            try:
                out[key] = np.asarray([float(v) for v in value.split()])
            except ValueError:
                out[key] = value
    return out


def generate_depth_map(calib_dir: str, velo_path: str, cam: int = 2,
                       vel_depth: bool = False) -> np.ndarray:
    """Sparse depth map [H,W] in the rectified camera `cam` (2=left, 3=right)."""
    cam2cam = read_calib_file(os.path.join(calib_dir, "calib_cam_to_cam.txt"))
    velo2cam_raw = read_calib_file(os.path.join(calib_dir, "calib_velo_to_cam.txt"))

    velo2cam = np.eye(4)
    velo2cam[:3, :3] = velo2cam_raw["R"].reshape(3, 3)
    velo2cam[:3, 3] = velo2cam_raw["T"]

    im_h, im_w = cam2cam["S_rect_02"][::-1].astype(np.int32)

    R_rect = np.eye(4)
    R_rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    P_rect = cam2cam[f"P_rect_0{cam}"].reshape(3, 4)
    P_velo2im = P_rect @ R_rect @ velo2cam

    velo = load_velodyne_points(velo_path)
    velo = velo[velo[:, 0] >= 0]  # points in front of the sensor

    proj = (P_velo2im @ velo.T).T  # [N,3]
    z = proj[:, 2]
    u = proj[:, 0] / z
    v = proj[:, 1] / z
    depth_vals = velo[:, 0] if vel_depth else z

    # KITTI matlab convention: round then -1 (reference kitti_utils.py:80-81)
    ui = np.round(u).astype(np.int64) - 1
    vi = np.round(v).astype(np.int64) - 1
    ok = (ui >= 0) & (vi >= 0) & (ui < im_w) & (vi < im_h)
    ui, vi, depth_vals = ui[ok], vi[ok], depth_vals[ok]

    # scatter-min: sort by (pixel, depth) so the first write per pixel wins
    flat = vi * im_w + ui
    order = np.lexsort((depth_vals, flat))
    flat, depth_vals = flat[order], depth_vals[order]
    first = np.ones(len(flat), dtype=bool)
    first[1:] = flat[1:] != flat[:-1]

    depth = np.zeros((im_h * im_w,), dtype=np.float32)
    depth[flat[first]] = depth_vals[first]
    depth[depth < 0] = 0
    return depth.reshape(im_h, im_w)
