"""The port's evaluation (``sfmnext_tpu_torch/evaluation.py``, the KITTI and
Cityscapes evaluation CLIs, ``export_gt_depth``) against the JAX package's,
on the CPU.

  * the whole slice: the port's ``evaluate()`` and the JAX ``evaluate()``
    on one fake KITTI tree (3 images, a ragged ``gt_depths.npz``) and one
    reference-layout folder of numpy-drawn weights (ResNet-18, 64x96,
    ``--post_process``): every metric within 1e-4 relative, the saved
    predictions within 1e-4 of their largest value (the one JAX compile);
    ``--eval_batch_size 2`` (a short last batch) gives batch 1's result;
  * ``resize_np_bilinear`` (up, down, equal sizes) and
    ``evaluate_predictions`` (eigen and not, median, stereo, scale factor,
    error maps) within 1e-6 relative (``std_ratio`` within 1e-6);
  * ``evaluate()`` on external predictions: its row and files, ``--no_eval``,
    the eigen-to-benchmark remap, and the benchmark split's 16-bit PNGs,
    which PIL decodes to the JAX export's arrays;
  * ``export_gt_depth``: ``eigen`` and ``eigen_benchmark`` equal the JAX
    npz exactly; the Cityscapes tool's metrics equal the JAX tool's on the
    same predictions (the forward monkeypatched out on both sides);
  * ``load_eval_variables``, ``--log_attn`` panels, the CLI with
    ``--no_cuda`` and, without it, no CPU fallback;
  * ``write_png``'s 16-bit grayscale, read back exactly by PIL.
"""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import sfmnext_tpu.evaluation as jax_eval
from sfmnext_tpu.config import parse_options as jax_parse_options
from sfmnext_tpu.training import builder as jax_builder
from sfmnext_tpu.training.builder import build_models as jax_build_models
from sfmnext_tpu.training.builder import init_params
from sfmnext_tpu.utils.torch_export import save_reference_style_checkpoint
from sfmnext_tpu_torch import evaluate_depth_config, evaluation, export_gt_depth
from sfmnext_tpu_torch.config import parse_options
from sfmnext_tpu_torch.tools import evaluate_depth_cityscapes_config as cityscapes_tool
from sfmnext_tpu_torch.utils.logging import write_png
from test_torch_data import SEQ, write_kitti_tree
from test_torch_models import _one_thread, numpy_variables  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--num_layers", "18", "--num_features", "64", "--model_dim", "16",
         "--patch_size", "4", "--query_nums", "16", "--dim_out", "16",
         "--height", "64", "--width", "96", "--num_workers", "1"]
METRICS = evaluation.METRIC_KEYS
GT_SHAPES = ((96, 320), (100, 330), (90, 300))


def _load_file(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _ragged_gt(rng, shapes=GT_SHAPES):
    gts = np.empty(len(shapes), object)
    for i, hw in enumerate(shapes):
        gts[i] = ((rng.rand(*hw) * 30 + 2) * (rng.rand(*hw) < 0.7)).astype(np.float32)
    return gts


def _both(argv):
    """The same command line as the JAX package's and the port's options."""
    return jax_parse_options(argv), parse_options(argv)


def _assert_rows(got, want, rtol):
    """The metrics and ``med_ratio`` within ``rtol``; ``std_ratio``, the
    spread of ratios around 1, within ``rtol`` of 1 (relative to itself it
    carries the ratios' error divided by their small spread)."""
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        atol = rtol if k == "std_ratio" else 0
        np.testing.assert_allclose(got[k], v, rtol=0 if atol else rtol, atol=atol, err_msg=k)


@pytest.fixture
def kitti_eval(tmp_path, monkeypatch):
    """Three 96x320 frames, the eigen split and its ragged GT."""
    rng = np.random.RandomState(0)
    frames = tmp_path / "data" / SEQ / "image_02" / "data"
    frames.mkdir(parents=True)
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, (96, 320, 3), np.uint8)).save(frames / f"{i:010d}.png")
    split = tmp_path / "splits" / "eigen"
    split.mkdir(parents=True)
    (split / "test_files.txt").write_text("\n".join(f"{SEQ} {i} l" for i in range(3)))
    np.savez_compressed(split / "gt_depths.npz", data=_ragged_gt(rng))
    monkeypatch.setenv("SFMNEXT_SPLITS", str(tmp_path / "splits"))
    return tmp_path


@pytest.fixture
def weights(tmp_path, monkeypatch):
    """A reference-layout folder of numpy-drawn weights. The JAX
    ``load_eval_variables`` initialises its variables before it loads the
    folder over them; that eager init (tens of seconds on a CPU) is
    replaced by these numpy-drawn variables of the same shapes, all of
    which the load overwrites."""
    opt = jax_parse_options(SMALL)
    models = jax_build_models(opt, train=False)
    variables = numpy_variables(lambda key: init_params(opt, models, key), 0)
    folder = tmp_path / "weights"
    save_reference_style_checkpoint(str(folder), variables["params"],
                                    variables["batch_stats"], opt)
    monkeypatch.setattr(jax_builder, "init_params", lambda opt, models, rng: variables)
    return folder


def test_evaluate_matches_jax_and_batches(kitti_eval, weights):
    argv = SMALL + ["--data_path", str(kitti_eval / "data"), "--eval_mono", "--post_process",
                    "--load_weights_folder", str(weights), "--save_pred_disps"]
    jax_opt, _ = _both(argv + ["--eval_out_dir", str(kitti_eval / "jax")])
    want = jax_eval.evaluate(jax_opt)
    got = evaluation.evaluate(parse_options(argv + ["--no_cuda", "--eval_out_dir",
                                                    str(kitti_eval / "port")]))
    _assert_rows(got, want, 1e-4)
    preds = np.load(kitti_eval / "port" / "disps_eigen_split.npy")
    expect = np.load(kitti_eval / "jax" / "disps_eigen_split.npy")
    assert preds.shape == expect.shape == (3, 32, 48)  # the decoder's resolution
    assert np.abs(preds - expect).max() <= 1e-4 * np.abs(expect).max()

    # the CLI, batches of 2 (the last one short): batch 1's result
    batched = evaluate_depth_config.main(argv + ["--no_cuda", "--eval_batch_size", "2",
                                                 "--eval_out_dir", str(kitti_eval / "b2")])
    _assert_rows(batched, got, 1e-5)
    twos = np.load(kitti_eval / "b2" / "disps_eigen_split.npy")
    assert np.abs(twos - preds).max() <= 1e-5 * np.abs(preds).max()


def test_evaluate_needs_a_card_without_no_cuda(kitti_eval, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = parse_options(SMALL + ["--data_path", str(kitti_eval / "data"), "--eval_mono"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluation.evaluate(opt)


@pytest.mark.parametrize("src,dst", [((48, 160), (375, 1242)), ((375, 1242), (96, 320)),
                                     ((40, 60), (40, 60))], ids=["up", "down", "equal"])
def test_resize_np_bilinear_matches_jax(src, dst):
    arr = (np.random.RandomState(1).rand(*src) * 20 + 0.5).astype(np.float32)
    want = jax_eval.resize_np_bilinear(arr, dst)
    got = evaluation.resize_np_bilinear(arr, dst)
    assert got.shape == want.shape == dst and got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("flags,split", [
    (["--eval_mono"], "eigen"),
    (["--eval_mono"], "eigen_benchmark"),
    (["--eval_stereo"], "eigen"),
    (["--eval_mono", "--disable_median_scaling", "--pred_depth_scale_factor", "30"], "eigen"),
], ids=["eigen_median", "non_eigen_median", "stereo", "scale_factor"])
def test_evaluate_predictions_matches_jax(flags, split):
    rng = np.random.RandomState(2)
    preds = (rng.rand(3, 48, 160) * 20 + 0.5).astype(np.float32)
    gts = _ragged_gt(rng)
    jax_opt, opt = _both(flags)
    want_maps, got_maps = [], []
    want = jax_eval.evaluate_predictions(jax_opt, preds, gts, split, error_maps_out=want_maps)
    got = evaluation.evaluate_predictions(opt, preds, gts, split, error_maps_out=got_maps)
    _assert_rows(got, want, 1e-6)
    assert ("med_ratio" in got) == (flags == ["--eval_mono"])
    for g, w in zip(got_maps, want_maps, strict=True):
        assert g.shape == w.shape and np.abs(g - w).max() <= 1e-6 * np.abs(w).max()


@pytest.mark.parametrize("case", ["rows_and_files", "no_eval", "eigen_to_benchmark"])
def test_evaluate_external_predictions_matches_jax(kitti_eval, case):
    preds = (np.random.RandomState(3).rand(3, 48, 160) * 20 + 0.5).astype(np.float32)
    ext = kitti_eval / "ext.npy"
    np.save(ext, preds)
    flags = {"rows_and_files": ["--save_pred_disps"],
             "no_eval": ["--no_eval"],
             "eigen_to_benchmark": ["--eval_eigen_to_benchmark", "--no_eval",
                                    "--save_pred_disps"]}[case]
    bench = kitti_eval / "splits" / "benchmark"
    bench.mkdir()
    np.save(bench / "eigen_to_benchmark_ids.npy", np.array([2, 0]))
    out = {}
    for name, (parse, evaluate) in {"jax": (jax_parse_options, jax_eval.evaluate),
                                    "port": (parse_options, evaluation.evaluate)}.items():
        out[name] = evaluate(parse(["--eval_mono", "--ext_disp_to_eval", str(ext), *flags,
                                    "--eval_out_dir", str(kitti_eval / name)]))
    _assert_rows(out["port"], out["jax"], 1e-6)
    if case == "no_eval":
        assert out["port"] == {}
    if "--save_pred_disps" not in flags:
        return
    disps = [np.load(kitti_eval / name / "disps_eigen_split.npy") for name in ("jax", "port")]
    assert np.array_equal(*disps)
    assert np.array_equal(disps[1], preds[[2, 0]] if case == "eigen_to_benchmark" else preds)
    if case == "rows_and_files":
        maps = [np.load(kitti_eval / name / "error_eigen_split.npy.npz",
                        allow_pickle=True)["data"] for name in ("jax", "port")]
        assert [m.shape for m in maps[1]] == list(GT_SHAPES)
        for g, w in zip(maps[1], maps[0], strict=True):
            assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()


@pytest.mark.parametrize("hw", [(352, 1216), (48, 160)], ids=["export_size", "decoder_size"])
def test_benchmark_pngs_match_jax(kitti_eval, hw):
    """The benchmark split's 352x1216 uint16 PNGs (depth 5.4/disp x 256,
    written by ``write_png``). At the export's own size the resize is the
    identity on both sides and the PNGs decode to equal arrays. From the
    decoder's size the two resizes differ by ~1e-7 relative (float32
    products against float64 interpolation), which turns the truncation to
    uint16 by one count on a few pixels: at most 1, on at most 1e-4 of
    them."""
    preds = (np.random.RandomState(4).rand(2, *hw) * 20 + 0.05).astype(np.float32)
    ext = kitti_eval / "ext.npy"
    np.save(ext, preds)
    argv = ["--eval_mono", "--eval_split", "benchmark", "--ext_disp_to_eval", str(ext)]
    for name, (parse, evaluate) in {"jax": (jax_parse_options, jax_eval.evaluate),
                                    "port": (parse_options, evaluation.evaluate)}.items():
        assert evaluate(parse(argv + ["--eval_out_dir", str(kitti_eval / name)])) == {}
    for idx in range(2):
        name = f"benchmark_predictions/{idx:010d}.png"
        want, got = (np.array(Image.open(kitti_eval / side / name)) for side in ("jax", "port"))
        assert got.dtype == want.dtype == np.uint16 and got.shape == want.shape == (352, 1216)
        diff = np.abs(got.astype(np.int64) - want)
        if hw == (352, 1216):
            assert not diff.any()
        else:
            assert diff.max() <= 1 and np.count_nonzero(diff) <= 1e-4 * diff.size, diff.sum()


def test_write_png_16_bit_grayscale(tmp_path):
    rng = np.random.RandomState(5)
    gray = rng.randint(0, 65536, (7, 9)).astype(np.uint16)
    rgb = rng.randint(0, 256, (7, 9, 3)).astype(np.uint8)
    write_png(str(tmp_path / "gray.png"), gray)
    write_png(str(tmp_path / "rgb.png"), rgb)
    back = Image.open(tmp_path / "gray.png")
    assert back.mode == "I;16" and np.array_equal(np.array(back), gray)
    assert np.array_equal(np.array(Image.open(tmp_path / "rgb.png")), rgb)
    with pytest.raises(ValueError, match="uint16"):
        write_png(str(tmp_path / "bad.png"), gray.astype(np.int32))


@pytest.mark.parametrize("split", ["eigen", "eigen_benchmark"])
def test_export_gt_depth_matches_jax(tmp_path, split):
    jax_export = _load_file("jax_export_gt_depth", ROOT / "export_gt_depth.py")
    data = tmp_path / "kitti"
    write_kitti_tree(data, np.random.RandomState(6), n_frames=3)
    files = "\n".join(f"{SEQ} {i} l" for i in range(3))
    out = {}
    for name, export in (("jax", jax_export.export_gt_depths_kitti),
                         ("port", export_gt_depth.export_gt_depths_kitti)):
        folder = tmp_path / name / split
        folder.mkdir(parents=True)
        (folder / "test_files.txt").write_text(files)
        if name == "port":
            export_gt_depth.main(["--data_path", str(data), "--split", split,
                                  "--splits_dir", str(tmp_path / name)])
        else:
            export(str(data), split, str(tmp_path / name))
        out[name] = np.load(folder / "gt_depths.npz", allow_pickle=True)["data"]
    # an object array of [H,W] maps (of one shape here, so numpy stacks them)
    assert out["port"].dtype == out["jax"].dtype == object
    assert len(out["port"]) == len(out["jax"]) == 3
    for got, want in zip(out["port"], out["jax"]):
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        assert got.shape == want.shape and np.array_equal(got, want) and got.max() > 0


@pytest.mark.parametrize("flags", [["--eval_mono"], ["--eval_stereo"]], ids=["mono", "stereo"])
def test_cityscapes_metrics_match_jax(tmp_path, monkeypatch, flags):
    """The tool after the forward: ``scaled_disp`` as the prediction, the
    GT's top 75% then [256:, 192:1856]; the forward returns fixed
    predictions on both sides (no model runs)."""
    jax_tool = _load_file("jax_cityscapes_tool",
                          ROOT / "tools" / "evaluate_depth_cityscapes_config.py")
    rng = np.random.RandomState(7)
    split = tmp_path / "splits" / "cityscapes"
    (split / "gt_depths").mkdir(parents=True)
    (split / "test_files.txt").write_text("berlin berlin_000000_000019\nbonn bonn_000000_000019")
    for i in range(2):
        gt = (rng.rand(400, 1900) * 60 + 1) * (rng.rand(400, 1900) < 0.5)
        np.save(split / "gt_depths" / f"{i:03d}_depth.npy", gt.astype(np.float32))
    raw = rng.rand(2, 24, 64).astype(np.float32)
    monkeypatch.setenv("SFMNEXT_SPLITS", str(tmp_path / "splits"))
    monkeypatch.setattr(jax_eval, "load_eval_variables", lambda opt: (None, None))
    monkeypatch.setattr(jax_eval, "predict_depths", lambda opt, m, v, loader, pp: raw)
    monkeypatch.setattr(evaluation, "load_eval_variables", lambda opt, device: None)
    monkeypatch.setattr(evaluation, "predict_depths", lambda opt, m, loader, pp: raw)
    argv = SMALL + flags + ["--eval_data_path", str(tmp_path / "cs")]
    want = jax_tool.evaluate_cityscapes(jax_parse_options(argv))
    got = cityscapes_tool.evaluate_cityscapes(parse_options(argv + ["--no_cuda"]))
    _assert_rows(got, want, 1e-6)


def test_load_eval_variables_and_attention_panels(tmp_path, capsys, monkeypatch):
    # panels as PNG files alone: importing TensorBoard pulls in TensorFlow
    # where it is installed, seconds of import; tests/test_torch_trainer.py
    # covers it
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    opt = parse_options(SMALL + ["--log_dir", str(tmp_path / "logs")])
    models = evaluation.load_eval_variables(opt, "cpu")
    assert "no --load_weights_folder" in capsys.readouterr().out
    assert next(models.encoder.parameters()).dtype == torch.float32
    assert not models.encoder.training and not models.depth.training
    (tmp_path / "orbax").mkdir()
    with pytest.raises(FileNotFoundError, match="ckpt_to_pth"):
        evaluation.load_eval_variables(dataclasses.replace(
            opt, load_weights_folder=str(tmp_path / "orbax")), "cpu")

    rng = np.random.RandomState(8)
    batches = [{"color": rng.rand(n, 1, 64, 96, 3).astype(np.float32)} for n in (2, 1)]
    plain = evaluation.predict_depths(opt, models, batches, post_process=False)
    logged = evaluation.predict_depths(dataclasses.replace(opt, log_attn=True), models, batches,
                                       post_process=False)
    assert plain.shape == (3, 32, 48) and np.array_equal(plain, logged)
    panels = sorted(p.name for p in (tmp_path / "logs" / "vis" / "images").iterdir())
    # 2 + 1 images, each a color, a disparity and 16 attention maps
    assert len(panels) == 3 * (2 + 16) and "step00000001_attn_0_15.png" in panels
