"""Precompute ground-truth depth maps for a KITTI eval split. Counterpart
of ``export_gt_depth.py``; host only (numpy, and PIL for eigen_benchmark).

Behavioral reference: export_gt_depth.py:19-65 — writes
splits/<split>/gt_depths.npz with key 'data' (object array of [H,W] maps):
eigen uses raw velodyne projection; eigen_benchmark uses the improved
png GT (depth/256).

    python -m sfmnext_tpu_torch.export_gt_depth --data_path <KITTI> --split eigen
"""

import argparse
import os

import numpy as np

from sfmnext_tpu_torch.data.kitti_utils import generate_depth_map
from sfmnext_tpu_torch.data.mono_dataset import pil_image, read_lines


def export_gt_depths_kitti(data_path: str, split: str, splits_dir: str = None):
    from sfmnext_tpu_torch.training.trainer import find_splits_dir

    splits_dir = splits_dir or find_splits_dir()
    split_folder = os.path.join(splits_dir, split)
    lines = read_lines(os.path.join(split_folder, "test_files.txt"))

    print(f"Exporting ground truth depths for {split}")
    gt_depths = []
    for line in lines:
        folder, frame_id, _ = line.split()
        frame_id = int(frame_id)
        if split == "eigen":
            calib_dir = os.path.join(data_path, folder.split("/")[0])
            velo = os.path.join(
                data_path, folder, f"velodyne_points/data/{frame_id:010d}.bin"
            )
            gt = generate_depth_map(calib_dir, velo, 2, vel_depth=True)
            gt = gt.astype(np.float32)
        elif split == "eigen_benchmark":
            path = os.path.join(
                data_path, folder,
                "proj_depth/groundtruth/image_02", f"{frame_id:010d}.png",
            )
            gt = np.asarray(pil_image().open(path)).astype(np.float32) / 256.0
        else:
            raise ValueError(f"unsupported split {split}")
        gt_depths.append(gt)

    out = os.path.join(split_folder, "gt_depths.npz")
    np.savez_compressed(out, data=np.array(gt_depths, dtype=object))
    print(f"Saved to {out}")


def main(argv=None):
    p = argparse.ArgumentParser(description="export_gt_depth")
    p.add_argument("--data_path", required=True)
    p.add_argument("--split", required=True, choices=["eigen", "eigen_benchmark"])
    p.add_argument("--splits_dir", default=None)
    args = p.parse_args(argv)
    export_gt_depths_kitti(args.data_path, args.split, args.splits_dir)


if __name__ == "__main__":
    main()
