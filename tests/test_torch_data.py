"""The port's datasets (``sfmnext_tpu_torch/data/``) against the JAX
package's, on tiny trees this module writes with PIL and numpy.

  * every dataset class (KITTI raw, also with the stereo frame, KITTI
    depth, KITTI odometry, NYU raw, MannequinChallenge with its
    ``KV_intrinsics.txt``, Cityscapes preprocessed and Cityscapes eval)
    yields the JAX class's items: ``color`` and ``depth_gt`` bit for bit,
    the intrinsics within 1e-7;
  * ``generate_depth_map`` (duplicate pixels included) equals the JAX
    function exactly;
  * ``training/trainer.make_dataset`` maps every ``--dataset`` name to the
    counterpart of the JAX class, built alike;
  * ``sfmnext_tpu_torch.train`` trains 2 steps at 64x96 on a KITTI tree
    and split from an argfile with ``--no_cuda``, no caller-given loaders;
  * ``PrefetchLoader`` keeps index order with several workers and raises
    a dataset's exception;
  * the datasets and the evaluation import without PIL, and a decode
    without PIL raises an ImportError that names it.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import sfmnext_tpu.config as jax_config
from sfmnext_tpu.data import kitti_utils as jax_kitti_utils
from sfmnext_tpu.training import trainer as jax_trainer
from sfmnext_tpu_torch import config, train
from sfmnext_tpu_torch.data import kitti_utils
from sfmnext_tpu_torch.data.loader import PrefetchLoader
from sfmnext_tpu_torch.data.mono_dataset import pil_image
from sfmnext_tpu_torch.training import trainer
from test_torch_models import _one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SEQ = "2011_09_26/2011_09_26_drive_0001_sync"
N_FRAMES = 5
IMG_HW = (40, 120)  # the raw frames; also the velodyne map's size (S_rect_02)
HW = (32, 48)  # the datasets' resolution
CS_FRAME = "berlin_000000_000019"


def _save_rgb(path, rng, hw):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.randint(0, 256, (*hw, 3), np.uint8)).save(path)


def _fmt(values):
    return " ".join(f"{v:.12e}" for v in np.ravel(values))


def write_kitti_tree(root, rng, n_frames=N_FRAMES, img_hw=IMG_HW):
    """A KITTI raw drive under ``root``: both cameras' png frames, the
    calibration, velodyne scans and the improved png ground truth of
    camera 2 and 3."""
    h, w = img_hw
    date = SEQ.split("/")[0]
    fx, cx, cy = 0.5 * w, 0.5 * w, 0.5 * h
    (root / date).mkdir(parents=True, exist_ok=True)
    (root / date / "calib_cam_to_cam.txt").write_text("\n".join([
        "calib_time: 09-Jan-2012 13:57:47",
        f"S_rect_02: {_fmt([w, h])}",
        f"R_rect_00: {_fmt(np.eye(3) + rng.randn(3, 3) * 1e-3)}",
        f"P_rect_02: {_fmt([[fx, 0, cx, 0.3], [0, fx, cy, 0], [0, 0, 1, 0.003]])}",
        f"P_rect_03: {_fmt([[fx, 0, cx, -0.2], [0, fx, cy, 0], [0, 0, 1, 0.003]])}",
    ]) + "\n")
    rot = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]]) + rng.randn(3, 3) * 1e-3
    (root / date / "calib_velo_to_cam.txt").write_text(
        f"calib_time: 15-Mar-2012 11:37:16\nR: {_fmt(rot)}\nT: {_fmt([0.01, -0.08, -0.27])}\n")
    drive = root / SEQ
    for i in range(n_frames):
        for cam in (2, 3):
            _save_rgb(str(drive / f"image_0{cam}" / "data" / f"{i:010d}.png"), rng, img_hw)
            gt = drive / "proj_depth" / "groundtruth" / f"image_0{cam}"
            gt.mkdir(parents=True, exist_ok=True)
            png = rng.randint(0, 20000, img_hw) * (rng.rand(*img_hw) < 0.3)
            Image.fromarray(png.astype(np.uint16)).save(gt / f"{i:010d}.png")
        n = 3000
        pts = np.stack([rng.uniform(-5, 40, n), rng.uniform(-15, 15, n),
                        rng.uniform(-2, 2, n), rng.rand(n)], 1)
        pts = np.concatenate([pts, pts[:300]])  # exact duplicates
        velo = drive / "velodyne_points" / "data"
        velo.mkdir(parents=True, exist_ok=True)
        pts.astype(np.float32).tofile(velo / f"{i:010d}.bin")
    return SEQ


def _write_odom(root, rng):
    for cam in (2, 3):
        for i in range(N_FRAMES):
            _save_rgb(str(root / "sequences" / "09" / f"image_{cam}" / f"{i:06d}.png"), rng,
                      IMG_HW)


def _write_frames(folder, rng, ext):
    for i in range(N_FRAMES):
        _save_rgb(str(folder / f"{i:010d}{ext}"), rng, IMG_HW)


def _write_cityscapes_preprocessed(root, rng):
    for city, frame in (("aachen", "aachen_000000_000010"), ("bochum", "bochum_000001_000007")):
        _save_rgb(str(root / city / f"{frame}.jpg"), rng, (24, 3 * 64))
        cam = [rng.uniform(500, 600), 0, rng.uniform(500, 520), 0, rng.uniform(500, 600),
               rng.uniform(180, 200), 0, 0, 1]
        (root / city / f"{frame}_cam.txt").write_text(",".join(f"{v:.6f}" for v in cam))


def _write_cityscapes_eval(root, rng):
    city = CS_FRAME.split("_")[0]
    for frame in (CS_FRAME, "berlin_000000_000017"):
        _save_rgb(str(root / "leftImg8bit_sequence" / "test" / city /
                      f"{frame}_leftImg8bit.png"), rng, (64, 128))
    cam_dir = root / "camera_trainvaltest" / "camera" / "test" / city
    cam_dir.mkdir(parents=True)
    intrinsic = {"fx": 2262.52, "fy": 2265.30, "u0": 1096.98, "v0": 513.137}
    (cam_dir / f"{CS_FRAME}_camera.json").write_text(json.dumps({"intrinsic": intrinsic}))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    rng = np.random.RandomState(0)
    write_kitti_tree(root / "kitti", rng)
    _write_odom(root / "odom", rng)
    _write_frames(root / "nyu" / "bedroom_0001", rng, ".png")
    for seq in ("seqA", "seqB"):
        _write_frames(root / "mc" / "data" / seq, rng, ".jpg")
    (root / "mc" / "KV_intrinsics.txt").write_text("seqA 0.91 1.62 0.49 0.52\n")
    _write_cityscapes_preprocessed(root / "cs", rng)
    _write_cityscapes_eval(root / "cs_eval", rng)
    return root


# name -> (module, class, data folder, split lines, frame ids, img_ext)
DATASETS = {
    "kitti_raw": ("kitti", "KITTIRAWDataset", "kitti", [f"{SEQ} 1 l", f"{SEQ} 3 r"],
                  [0, -1, 1], ".png"),
    "kitti_raw_stereo": ("kitti", "KITTIRAWDataset", "kitti", [f"{SEQ} 2 r", f"{SEQ} 1 l"],
                         [0, -1, 1, "s"], ".png"),
    "kitti_depth": ("kitti", "KITTIDepthDataset", "kitti", [f"{SEQ} 1 l", f"{SEQ} 2 r"],
                    [0, -1, 1], ".png"),
    "kitti_odom": ("kitti", "KITTIOdomDataset", "odom", ["9 1 l", "9 3 r"], [0, -1, 1], ".png"),
    "nyu_raw": ("nyu", "NYURawDataset", "nyu", ["bedroom_0001 1", "bedroom_0001 3"],
                [0, -1, 1], ".png"),
    "mannequin": ("mannequin", "MCDataset", "mc/data", ["seqA 1", "seqB 2"], [0, -1, 1],
                  ".jpg"),
    "cityscapes_preprocessed": ("cityscapes", "CityscapesPreprocessedDataset", "cs",
                                ["aachen aachen_000000_000010", "bochum bochum_000001_000007"],
                                [0, -1, 1], ".jpg"),
    "cityscapes_eval": ("cityscapes", "CityscapesEvalDataset", "cs_eval",
                        [f"berlin {CS_FRAME}"], [0, -1], ".png"),
}


def _dataset_pair(name, trees):
    import importlib

    module, cls, folder, lines, frames, ext = DATASETS[name]
    args = (str(trees / folder), lines, *HW, frames)
    return [getattr(importlib.import_module(f"{pkg}.data.{module}"), cls)(
        *args, is_train=True, img_ext=ext) for pkg in ("sfmnext_tpu", "sfmnext_tpu_torch")]


@pytest.mark.parametrize("name", list(DATASETS))
def test_dataset_items_match_jax(name, trees):
    expect_ds, port_ds = _dataset_pair(name, trees)
    assert type(port_ds).__module__.startswith("sfmnext_tpu_torch.")
    assert len(port_ds) == len(expect_ds) and port_ds.load_depth == expect_ds.load_depth
    for i in range(len(expect_ds)):
        want, got = expect_ds[i], port_ds[i]
        assert sorted(got) == sorted(want), (sorted(got), sorted(want))
        for key, value in want.items():
            assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
            if key in ("color", "depth_gt"):
                assert np.array_equal(got[key], value), key
            else:
                np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-7, err_msg=key)
    if name.startswith("kitti_raw") or name == "kitti_depth":
        assert got["depth_gt"].shape == (375, 1242, 1) and got["depth_gt"].max() > 0
    if name == "mannequin":  # seqA from KV_intrinsics.txt, seqB the default K
        assert port_ds[0]["K3x3"][0, 0] == np.float32(0.91) * HW[1]
        assert port_ds[1]["K3x3"][0, 0] == np.float32(0.9) * HW[1]


@pytest.mark.parametrize("cam,vel_depth", [(2, False), (3, True)])
def test_generate_depth_map_matches_jax(trees, cam, vel_depth):
    calib = str(trees / "kitti" / SEQ.split("/")[0])
    velo = str(trees / "kitti" / SEQ / "velodyne_points" / "data" / f"{2:010d}.bin")
    got = kitti_utils.generate_depth_map(calib, velo, cam, vel_depth=vel_depth)
    want = jax_kitti_utils.generate_depth_map(calib, velo, cam, vel_depth=vel_depth)
    assert got.dtype == want.dtype and got.shape == IMG_HW
    assert np.array_equal(got, want)
    # pixels hit by more than one point (the duplicates, and nearby points)
    # keep the nearest: fewer filled pixels than points inside the image
    assert 0 < np.count_nonzero(got) < 3000


@pytest.mark.parametrize("dataset", ["kitti", "kitti_odom", "kitti_depth",
                                     "cityscapes_preprocessed", "nyu_raw", "mc_dataset",
                                     "mc_mini_dataset"])
def test_make_dataset_maps_every_name(dataset, trees):
    argv = ["--dataset", dataset, "--data_path", str(trees / "kitti"), "--height", "32",
            "--width", "48", "--frame_ids", "0", "-1", "1", "--use_stereo"]
    # a .txt value on the command line would be read as an argfile
    kv = dict(intrinsics_file_path=str(trees / "mc" / "KV_intrinsics.txt"))
    files = [f"{SEQ} 1 l"]
    want = jax_trainer.make_dataset(
        dataclasses.replace(jax_config.parse_options(argv), **kv), files, True)
    got = trainer.make_dataset(dataclasses.replace(config.parse_options(argv), **kv), files, True)
    assert type(got).__name__ == type(want).__name__
    assert type(got).__module__ == type(want).__module__.replace("sfmnext_tpu.",
                                                                 "sfmnext_tpu_torch.")
    for attr in ("data_path", "filenames", "height", "width", "frame_idxs", "is_train",
                 "img_ext", "load_depth"):
        assert getattr(got, attr) == getattr(want, attr), attr
    if dataset.startswith("mc"):
        assert sorted(got.kv_intrinsics) == sorted(want.kv_intrinsics) == ["seqA"]


def test_train_cli_trains_on_kitti_files(trees, tmp_path, monkeypatch):
    """``python -m sfmnext_tpu_torch.train <argfile> --no_cuda --data_path
    <tree>``: the Trainer builds its loaders from the split files, trains 2
    steps and validates on batches with the velodyne ground truth."""
    split = tmp_path / "splits" / "tiny"
    split.mkdir(parents=True)
    (split / "train_files.txt").write_text(
        "\n".join(f"{SEQ} {i} {side}" for i, side in ((1, "l"), (2, "l"), (3, "l"), (2, "r"))))
    (split / "val_files.txt").write_text(f"{SEQ} 2 l\n{SEQ} 3 r\n")
    monkeypatch.setenv("SFMNEXT_SPLITS", str(tmp_path / "splits"))
    # the metrics go to the jsonl streams alone: importing TensorBoard pulls
    # in TensorFlow where it is installed, seconds of import;
    # tests/test_torch_trainer.py covers it
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    argfile = tmp_path / "tiny.txt"
    argfile.write_text("--num_layers 18\n--num_features 64\n--model_dim 16\n--patch_size 4\n"
                       "--query_nums 16\n--dim_out 16\n--height 64\n--width 96\n"
                       "--batch_size 2\n--compute_dtype float32\n--weights_init scratch\n"
                       "--split tiny\n--steps_per_epoch 2\n--num_epochs 1\n"
                       "--log_frequency 1\n--num_workers 2\n")
    train.main([str(argfile), "--no_cuda", "--data_path", str(trees / "kitti"),
                "--log_dir", str(tmp_path / "runs")])
    run = tmp_path / "runs" / "mdp"
    for mode in ("train", "val"):
        lines = (run / mode / "metrics.jsonl").read_text().splitlines()
        recs = [json.loads(line) for line in lines]
        assert [r["step"] for r in recs] == [0, 1], mode
        assert all(np.isfinite(r["loss"]) and np.isfinite(r["de/abs_rel"]) for r in recs), recs
    assert (run / "models" / "weights_0" / "encoder.pth").exists()


class _Slow:
    """Items that take a random time, and optionally raise at one index."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at
        self.rng = np.random.RandomState(0)
        self.delays = self.rng.rand(n) * 0.01

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(self.delays[i])
        if i == self.fail_at:
            raise FileNotFoundError(f"no frame {i}")
        return {"x": np.array([i])}


def test_prefetch_loader_keeps_order_and_raises():
    loader = PrefetchLoader(_Slow(30), 4, shuffle=False, num_workers=4, drop_last=False)
    assert [i for b in loader for i in b["x"][:, 0]] == list(range(30))
    shuffled = [b["x"][:, 0].tolist() for b in PrefetchLoader(_Slow(30), 4, num_workers=4,
                                                              seed=3)]
    one = [b["x"][:, 0].tolist() for b in PrefetchLoader(_Slow(30), 4, num_workers=1, seed=3)]
    assert shuffled == one  # the workers change nothing but the speed
    with pytest.raises(FileNotFoundError, match="no frame 17"):
        list(PrefetchLoader(_Slow(30, fail_at=17), 4, shuffle=False, num_workers=4))


def test_data_and_evaluation_import_without_pil(monkeypatch):
    code = ("import sys; sys.modules['PIL'] = None\n"
            "import sfmnext_tpu_torch.evaluation, sfmnext_tpu_torch.export_gt_depth\n"
            "import sfmnext_tpu_torch.tools.evaluate_depth_cityscapes_config\n"
            "from sfmnext_tpu_torch.data import cityscapes, kitti, mannequin, nyu\n"
            "from sfmnext_tpu_torch.data.mono_dataset import pil_load\n"
            "try:\n    pil_load('frame.png')\nexcept ImportError as e:\n    print(e)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('PIL', 'jax', 'sfmnext_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout.splitlines()
    assert "needs PIL" in out[0] and out[1] == "['PIL']", out  # PIL: the blocked entry
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        pil_image()
