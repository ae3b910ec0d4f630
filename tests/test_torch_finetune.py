"""The port's metric finetuning and metric evaluation against the JAX
package, on the CPU in float32:

  * ``silog_loss``, ``l2_loss`` and ``bins_chamfer_loss``, masked and not:
    values and gradients (autograd against ``jax.grad``) to 1e-5 relative;
  * ``onecycle_schedule`` at every count of the cycle and past it, T = 4
    (clamped to 10) and T = 100: optax's formula evaluated in float64 to
    1e-7 relative, optax's float32 evaluation (what the JAX trainer steps
    with) to 2^-22 of the peak rate (its anneal's rounding, read 1.1e-7);
  * the 0.1 global-norm clip and AdamW over 5 updates of a parameter dict,
    3 of them over the clip and one parameter without a gradient, against
    ``make_finetune_optimizer``'s optax chain: 1e-6 relative, 1e-8 absolute;
  * ``_masked_median_per_sample`` (odd, even, empty and full masks) and
    ``garg_mask`` exactly; ``predict_tta`` on a function that is not
    symmetric under the flip;
  * two finetune steps at ``tests/test_finetune.py``'s tiny model
    (ResNet-18, 64x96, batch 4, sparse GT at 80x120, dropout off on both
    sides) on numpy-drawn weights: the losses to 1e-5 relative, each
    encoder and depth parameter's movement to 1e-3 of its norm plus the
    float32 rounding of the parameter (the biases ahead of a BatchNorm, whose
    gradient is rounding noise, to the steps' rates), the encoder's
    BatchNorm statistics to 1e-5 relative. The JAX step is this
    module's one JAX compile;
  * ``DepthDataset`` against the JAX class item by item, exactly, on trees
    the test writes (KITTI with and without the kb-crop, NYU 640x480; train
    with and without the rotation, and eval; a record without GT);
  * the two CLIs on a tiny tree: ``finetune_metric_depth.main`` for one
    epoch of 2 steps with an eval list, then ``evaluate_metric_depth.main``
    on its ``best`` folder with no crop, ``--garg_crop`` and
    ``--eigen_crop``, each dict against the JAX ``evaluate`` run on the
    port's own predictions (its network monkeypatched out) to 1e-6
    relative; the uncropped one equals the finetune validation's; both
    need a card without ``--no_cuda``; ``parse_ft`` splits the argfiles'
    words as the JAX one does;
  * ``FinetuneTrainer``: a batch without GT is skipped and does not count
    as an update; the warm start loads a ``.pth`` folder by either flag
    and refuses a folder without ``encoder.pth``.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import evaluate_metric_depth as jax_evaluate_metric_depth
import finetune_metric_depth as jax_finetune_metric_depth
from sfmnext_tpu.config import parse_options as jax_parse_options
from sfmnext_tpu.finetune import trainer as jax_ft
from sfmnext_tpu.finetune.dataloader import DepthDataset as JaxDepthDataset
from sfmnext_tpu.ops import losses as jax_losses
from sfmnext_tpu.training import builder as jax_builder
from sfmnext_tpu.training.step import TrainState
from sfmnext_tpu_torch import evaluate_metric_depth, finetune_metric_depth
from sfmnext_tpu_torch.config import parse_options
from sfmnext_tpu_torch.finetune import FinetuneTrainer, trainer as ft
from sfmnext_tpu_torch.finetune.dataloader import DepthDataset
from sfmnext_tpu_torch.ops import losses
from sfmnext_tpu_torch.training.builder import build_models
from sfmnext_tpu_torch.utils import torch_export
from sfmnext_tpu_torch.utils.jax_weights import from_jax_variables
from test_torch_models import _one_thread, numpy_variables  # noqa: F401


ARGS = ["--num_layers", "18", "--num_features", "64", "--model_dim", "16",
        "--patch_size", "4", "--query_nums", "16", "--dim_out", "16",
        "--height", "64", "--width", "96", "--max_depth", "10", "--compute_dtype", "float32"]
LR, TOTAL_STEPS = 1e-3, 50


def _close(got, want, rtol):
    """Elementwise within rtol of each value, with rtol of the largest as
    the floor."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


# ------------------------------------------------------------------ losses


def _depths(rng, shape):
    return rng.uniform(0.5, 10.0, shape).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("name", ["silog_loss", "l2_loss"])
def test_pixel_losses_and_gradients_match_jax(name, masked):
    rng = np.random.RandomState(1)
    pred, target = _depths(rng, (2, 12, 16, 1)), _depths(rng, (2, 12, 16, 1))
    mask = rng.rand(2, 12, 16, 1) < 0.4 if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    want, want_grads = jax.value_and_grad(
        lambda p, t: getattr(jax_losses, name)(p, t, jmask), argnums=(0, 1))(
        jnp.asarray(pred), jnp.asarray(target))
    p, t = (torch.tensor(a, requires_grad=True) for a in (pred, target))
    got = getattr(losses, name)(p, t, None if mask is None else torch.from_numpy(mask))
    got.backward()
    _close(got.item(), float(want), 1e-5)
    _close(p.grad.numpy(), want_grads[0], 1e-5)
    _close(t.grad.numpy(), want_grads[1], 1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_bins_chamfer_loss_and_gradients_match_jax(masked):
    rng = np.random.RandomState(2)
    edges = np.sort(rng.uniform(0.0, 10.0, (2, 9)), axis=1).astype(np.float32)
    target = _depths(rng, (2, 6, 7, 1))
    target[rng.rand(*target.shape) < 0.3] = 0.0  # invalid below 1e-3 without a mask
    mask = rng.rand(*target.shape) < 0.5 if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    want, want_grads = jax.value_and_grad(
        lambda e, t: jax_losses.bins_chamfer_loss(e, t, jmask), argnums=(0, 1))(
        jnp.asarray(edges), jnp.asarray(target))
    e, t = (torch.tensor(a, requires_grad=True) for a in (edges, target))
    got = losses.bins_chamfer_loss(e, t, None if mask is None else torch.from_numpy(mask))
    got.backward()
    _close(got.item(), float(want), 1e-5)
    _close(e.grad.numpy(), want_grads[0], 1e-5)
    _close(t.grad.numpy(), want_grads[1], 1e-5)


# ------------------------------------------------------ schedule, optimizer


@pytest.mark.parametrize("total", [4, 100])
def test_onecycle_schedule_matches_optax(total):
    counts = np.arange(max(total, 10) + 3)
    got = np.array([ft.onecycle_schedule(LR, total)(int(k)) for k in counts])
    sched = jax_ft.onecycle_schedule(LR, total)
    with jax.enable_x64(True):
        want64 = np.asarray(jax.vmap(sched)(jnp.asarray(counts, jnp.int64)))
    want32 = np.asarray(jax.vmap(sched)(jnp.asarray(counts, jnp.int32)))
    assert want64.dtype == np.float64 and want32.dtype == np.float32
    np.testing.assert_allclose(got, want64, rtol=1e-7, atol=0)
    np.testing.assert_allclose(got, want32, rtol=0, atol=2.0 ** -22 * LR)
    assert got[int(0.3 * max(total, 10))] == pytest.approx(LR, rel=1e-12)


def test_clip_and_adamw_match_optax():
    """Five updates; the gradients' global norms are about 0.06, 5.0, 0.08,
    23 and 0.45 against the 0.1 clip. "c" gets no gradient in the port and
    zeros in optax: AdamW decays it. One shape for all three keeps optax's
    eager dispatch to one compile of each operation."""
    rng = np.random.RandomState(3)
    shapes = {"a": (6, 2), "b": (6, 2), "c": (6, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * scale * (k != "c")).astype(np.float32)
              for k, s in shapes.items()} for scale in (0.01, 1.0, 0.02, 5.0, 0.1)]
    tx = jax_ft.make_finetune_optimizer(LR, TOTAL_STEPS, weight_decay=0.1)
    state, want = tx.init(params), params
    for g in grads:
        updates, state = tx.update(g, state, want)
        want = optax.apply_updates(want, updates)

    got = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    adamw, scheduler = ft.make_finetune_optimizer(got.values(), LR, TOTAL_STEPS, 0.1)
    schedule = ft.onecycle_schedule(LR, TOTAL_STEPS)
    for k, g in enumerate(grads):
        assert adamw.param_groups[0]["lr"] == schedule(k)
        for name, p in got.items():
            p.grad = None if name == "c" else torch.from_numpy(g[name])
        ft.finetune_update(adamw, scheduler)
    assert scheduler.last_epoch == len(grads)
    for name, p in got.items():
        assert not np.allclose(p.detach().numpy(), params[name])
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[name]), rtol=1e-6,
                                   atol=1e-8, err_msg=name)


# --------------------------------------------------- median, crop, TTA


def test_masked_median_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.uniform(0, 10, (4, 10, 14, 1)).astype(np.float32)
    mask = np.zeros(x.shape, bool)
    mask.reshape(4, -1)[0, rng.choice(140, 37, replace=False)] = True  # odd count
    mask.reshape(4, -1)[1, rng.choice(140, 52, replace=False)] = True  # even count
    mask[3] = True  # sample 2's stays empty
    got = ft._masked_median_per_sample(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    want = np.asarray(jax_ft._masked_median_per_sample(jnp.asarray(x), jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[2])
    assert got[1] == np.sort(x[1][mask[1]])[25]  # the lower median


@pytest.mark.parametrize("hw", [(23, 37), (80, 120), (375, 1242)])
def test_garg_mask_matches_jax(hw):
    gt = np.random.RandomState(5).uniform(-1.0, 12.0, (2, *hw, 1)).astype(np.float32)
    got = ft.garg_mask(torch.from_numpy(gt), 1e-3, 10.0).numpy()
    want = np.asarray(jax_ft.garg_mask(jnp.asarray(gt), 1e-3, 10.0))
    np.testing.assert_array_equal(got, want)


def test_predict_tta_matches_jax_on_an_asymmetric_function():
    images = np.random.RandomState(6).rand(2, 5, 9, 3).astype(np.float32)
    want = np.asarray(jax_ft.predict_tta(
        lambda x: jnp.cumsum(x.mean(-1, keepdims=True), axis=2), jnp.asarray(images)))
    nchw = torch.from_numpy(images).permute(0, 3, 1, 2)
    got = ft.predict_tta(lambda x: torch.cumsum(x.mean(1, keepdim=True), dim=3), nchw)
    _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-6)
    assert not np.allclose(want, np.cumsum(images.mean(-1, keepdims=True), axis=2))


# ------------------------------------------------------------ the step


def _ft_batches():
    rng = np.random.RandomState(7)
    out = []
    for _ in range(2):
        depth = rng.uniform(1.0, 9.0, (4, 80, 120, 1)) * (rng.rand(4, 80, 120, 1) < 0.3)
        out.append({"image": rng.rand(4, 64, 96, 3).astype(np.float32),
                    "depth": depth.astype(np.float32)})
    return out


@pytest.fixture(scope="module")
def steps():
    """Two finetune steps on each side from the same numpy-drawn weights."""
    jax_opt = jax_parse_options(ARGS)
    jax_models = jax_builder.build_models(jax_opt, train=True)
    # no PoseCNN: the JAX finetune state carries one, whose gradient is zero
    # (it adds nothing to the clip's norm) and which nothing reads
    jax_models = dataclasses.replace(jax_models, pose=None,
                                     depth=jax_models.depth.clone(deterministic=True))
    variables = numpy_variables(lambda key: jax_builder.init_params(jax_opt, jax_models, key), 11)
    tx = jax_ft.make_finetune_optimizer(LR, TOTAL_STEPS)
    state = TrainState.create(variables, tx)
    step = jax_ft.make_finetune_step(jax_opt, jax_models, tx, max_depth=10.0, donate=False)
    batches = _ft_batches()
    jax_losses_ = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
        jax_losses_.append(float(m["loss"]))

    opt = parse_options(ARGS)
    models = build_models(opt, "cpu", train=True, depth_only=True)
    for name, sd in from_jax_variables(variables).items():
        if name in ("encoder", "depth"):
            getattr(models, name).load_state_dict(sd, strict=True)
    for m in models.depth.modules():  # dropout off, BatchNorm still on batch statistics
        if isinstance(m, (torch.nn.Dropout, torch.nn.MultiheadAttention)):
            m.eval()
    before = {n: {k: v.clone() for k, v in getattr(models, n).state_dict().items()}
              for n in ("encoder", "depth")}
    params = [p for mod in models.modules().values() for p in mod.parameters()]
    adamw, scheduler = ft.make_finetune_optimizer(params, LR, TOTAL_STEPS)
    port_step = ft.make_finetune_step(models, adamw, scheduler, max_depth=10.0)
    port_losses = [port_step({k: torch.from_numpy(v) for k, v in b.items()})["loss"].item()
                   for b in batches]
    state = jax.tree_util.tree_map(np.asarray, state)
    want = {"encoder": torch_export.export_resnet_encoder_decoder(
                state.params["encoder"], state.batch_stats["encoder"]),
            "depth": torch_export.export_sql_decoder(state.params["depth"])}
    return dict(jax_losses=jax_losses_, port_losses=port_losses, models=models, want=want,
                before=before, scheduler=scheduler)


def test_finetune_losses_match_jax(steps):
    np.testing.assert_allclose(steps["port_losses"], steps["jax_losses"], rtol=1e-5)
    assert steps["scheduler"].last_epoch == 2


# the convolution biases ahead of a BatchNorm (DecoderBN's up blocks): the
# BatchNorm takes the mean out, so their gradient is zero but for rounding
BIAS_BEFORE_BN = re.compile(r"decoder\.up\d\._net\.[03]\.bias$")


@pytest.mark.parametrize("name", ["encoder", "depth"])
def test_finetune_parameters_match_jax(steps, name):
    """Each parameter's movement over the 2 steps, to 1e-3 of the movement's
    norm plus 2 float32 epsilons of the parameter's norm (the rounding of
    the stored values). Adam scales a gradient that is rounding noise up to
    a step of about the rate, either way: the biases ahead of a BatchNorm
    are held instead to move by at most the two steps' rates plus their
    decay, on both sides."""
    got = dict(getattr(steps["models"], name).named_parameters())
    before, want = steps["before"][name], steps["want"][name]
    rates = sum(ft.onecycle_schedule(LR, TOTAL_STEPS)(k) for k in range(2))
    eps = np.finfo(np.float32).eps
    noise = 0
    for k, p in got.items():
        w, b = np.asarray(want[k]), before[k].numpy()
        d_got, d_want = p.detach().numpy() - b, w - b
        assert np.abs(d_want).max() > 0, k
        if BIAS_BEFORE_BN.search(k):
            noise += 1
            limit = 1.01 * rates * (1 + 0.1 * np.abs(b))
            assert (np.abs(d_got) <= limit).all() and (np.abs(d_want) <= limit).all(), k
            continue
        err = np.linalg.norm(d_got - d_want)
        limit = 1e-3 * np.linalg.norm(d_want) + 2 * eps * np.linalg.norm(w)
        assert err <= limit, (k, err, limit)
    assert noise == (8 if name == "encoder" else 0)


def test_finetune_batchnorm_statistics_match_jax(steps):
    """The encoder's running statistics after the 2 steps, to 1e-5
    relative. A BatchNorm behind one of the biases above sees its batch
    mean shifted by that bias's first step, which differs between the sides
    by up to twice the first rate: its running mean gets 0.1 (the momentum)
    of that on top."""
    got = steps["models"].encoder.state_dict()
    want = steps["want"]["encoder"]
    keys = [k for k in want if ".running_" in k]
    assert len(keys) == 2 * 28
    behind = re.compile(r"decoder\.up\d\._net\.[14]\.running_mean$")
    shift = 0.1 * 2 * ft.onecycle_schedule(LR, TOTAL_STEPS)(0)
    assert sum(bool(behind.search(k)) for k in keys) == 8
    for k in keys:
        assert not torch.equal(got[k], steps["before"]["encoder"][k]), k
        atol = 1e-6 + (shift if behind.search(k) else 0.0)
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, atol=atol, err_msg=k)


# --------------------------------------------------------- DepthDataset


def _write(path, array):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(array).save(path)


@pytest.fixture(scope="module")
def depth_tree(tmp_path_factory):
    """KITTI 1242x375 (larger than the kb-crop) and NYU 640x480 frames
    with 16-bit GT, each listed twice, then a record whose GT is missing."""
    root = tmp_path_factory.mktemp("depth_tree")
    rng = np.random.RandomState(8)
    for name, (h, w), scale in (("kitti", (375, 1242), 256), ("nyu", (480, 640), 1000)):
        _write(root / "img" / f"{name}.png", rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
        gt = rng.uniform(1, 50, (h, w)) * scale * (rng.rand(h, w) < 0.3)
        _write(root / "gt" / f"{name}.png", gt.astype(np.uint16))
        (root / f"{name}.txt").write_text(
            f"{name}.png {name}.png 700.5\n{name}.png {name}.png\n{name}.png missing.png 1.0\n")
    return root


# (dataset, mode, extra keywords): the rotation off (degree 0) and the
# KITTI kb-crop off take other branches and another sequence of draws
DATASET_CASES = [("kitti", "train", {}), ("kitti", "eval", {}), ("nyu", "train", {}),
                 ("nyu", "eval", {}), ("kitti", "train", {"degree": 0.0}),
                 ("nyu", "train", {"degree": 0.0}), ("kitti", "train", {"do_kb_crop": False})]


@pytest.mark.parametrize("dataset,mode,extra", DATASET_CASES, ids=str)
def test_depth_dataset_matches_jax(depth_tree, dataset, mode, extra):
    kw = dict(mode=mode, dataset=dataset, input_height=96, input_width=128, seed=3, **extra)
    args = (str(depth_tree / "img"), str(depth_tree / "gt"), str(depth_tree / f"{dataset}.txt"))
    got, want = DepthDataset(*args, **kw), JaxDepthDataset(*args, **kw)
    assert len(got) == len(want) == 3
    for i in range(len(got)):
        a, b = got[i], want[i]
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (i, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"item {i} {k}")
    assert not bool(a["has_valid_depth"])


# ------------------------------------------------------------- the CLIs


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """A tiny KITTI-layout tree (96x128 frames, smaller than the kb-crop),
    4 training and 2 eval records, finetuned for one epoch of 2 steps. The
    finetune flags come in argfiles, as ``inc_kitti.txt`` brings them: both
    CLIs read a bare ``.txt`` word on the command line as an argfile, a
    list's path too."""
    root = tmp_path_factory.mktemp("ft_cli")
    rng = np.random.RandomState(9)
    for i in range(6):
        _write(root / "data" / f"f{i}.png", rng.randint(0, 256, (96, 128, 3), dtype=np.uint8))
        gt = rng.uniform(1, 9, (96, 128)) * 256 * (rng.rand(96, 128) < 0.3)
        _write(root / "gt" / f"f{i}.png", gt.astype(np.uint16))
    (root / "train.txt").write_text("".join(f"f{i}.png f{i}.png 721.5\n" for i in range(4)))
    (root / "eval.txt").write_text("f4.png f4.png 721.5\nf5.png f5.png 721.5\n")
    (root / "eval_args.txt").write_text(
        f"--gt_path {root / 'gt'}\n--filenames_file_eval {root / 'eval.txt'}\n"
        "--max_depth_eval 10\n")
    (root / "ft_args.txt").write_text(
        f"--filenames_file {root / 'train.txt'}\n--bs 2\n--epochs 1\n--input_height 64\n"
        "--input_width 96\n--lr 1e-3\n--wd 0.01\n")
    common = ARGS + ["--no_cuda", "--num_workers", "1", "--data_path", str(root / "data"),
                     "--log_dir", str(root / "runs"), str(root / "eval_args.txt")]
    trainer = finetune_metric_depth.main(common + [str(root / "ft_args.txt")])
    best = root / "runs" / "mdp" / "finetune" / "weights_best"
    return dict(trainer=trainer, common=common, best=best)


def test_finetune_cli_trains_and_saves(cli_run):
    trainer = cli_run["trainer"]
    assert trainer.step == 2 and trainer.scheduler.last_epoch == 2
    assert trainer.optimizer.param_groups[0]["weight_decay"] == 0.01
    for tag in ("best", "latest"):
        folder = cli_run["best"].parent / f"weights_{tag}"
        assert sorted(p.name for p in folder.iterdir()) == ["adam.pth", "depth.pth",
                                                           "encoder.pth"]


@pytest.mark.parametrize("flags", [[], ["--garg_crop"], ["--eigen_crop"]], ids=str)
def test_metric_eval_cli_matches_jax_evaluate(cli_run, flags, monkeypatch):
    argv = cli_run["common"] + ["--checkpoint_path", str(cli_run["best"]), *flags]
    preds, tta = [], ft.predict_tta

    def recording(infer, images):
        out = tta(infer, images)
        preds.append(out.permute(0, 2, 3, 1).numpy())
        return out

    monkeypatch.setattr(ft, "predict_tta", recording)
    got = evaluate_metric_depth.main(argv)
    assert len(preds) == 2

    # the JAX evaluate on the port's predictions: its network never runs
    replay = iter(preds)
    monkeypatch.setattr(jax_builder, "build_models", lambda opt, train: None)
    monkeypatch.setattr(jax_builder, "init_params",
                        lambda opt, models, rng: {"params": {}, "batch_stats": {}})
    monkeypatch.setattr(jax_ft, "predict_tta", lambda infer, images: next(replay))
    want = jax_evaluate_metric_depth.main(argv)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    if not flags:
        # the finetune validation scored the same weights on the same list
        trainer = cli_run["trainer"]
        val = trainer.validate(max_depth=10.0)
        for k in want:
            np.testing.assert_allclose(val[k], got[k], rtol=1e-6, err_msg=k)


# ------------------------------------------------- trainer, entry points


def _tiny_batch(rng, valid=True):
    depth = rng.uniform(1.0, 9.0, (2, 64, 96, 1)) * (rng.rand(2, 64, 96, 1) < 0.3)
    return {"image": rng.rand(2, 64, 96, 3).astype(np.float32),
            "depth": depth.astype(np.float32), "has_valid_depth": np.full(2, valid)}


def test_finetune_trainer_skips_batches_without_depth(tmp_path):
    rng = np.random.RandomState(10)
    loader = [_tiny_batch(rng), _tiny_batch(rng, valid=False), _tiny_batch(rng)]
    opt = parse_options(ARGS + ["--no_cuda", "--log_dir", str(tmp_path)])
    trainer = FinetuneTrainer(opt, loader, lr=LR, epochs=1)
    assert trainer.train(log_every=1) is None  # no test loader: no validation
    assert trainer.step == trainer.scheduler.last_epoch == 2
    assert len(trainer.losses) == 2 and all(np.isfinite(trainer.losses))
    assert {float(s["step"]) for s in trainer.optimizer.state.values()} == {2.0}
    assert trainer.optimizer.param_groups[0]["lr"] == ft.onecycle_schedule(LR, 3)(2)
    assert trainer.models.pose is None and trainer.models.rectify is None


@pytest.mark.parametrize("flags", [["--load_weights_folder"],
                                   ["--load_pretrained_model", "--load_pt_folder"]], ids=str)
def test_finetune_warm_start_loads_a_pth_folder(tmp_path, flags):
    saved = build_models(parse_options(ARGS + ["--seed", "3"]), "cpu", train=True,
                         depth_only=True)
    for name in ("encoder", "depth"):
        torch.save(getattr(saved, name).state_dict(), tmp_path / f"{name}.pth")
    opt = parse_options(ARGS + ["--no_cuda", "--log_dir", str(tmp_path), *flags, str(tmp_path)])
    trainer = FinetuneTrainer(opt, [None], epochs=1)
    for name in ("encoder", "depth"):
        want, got = getattr(saved, name).state_dict(), getattr(trainer.models, name).state_dict()
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want), name


def test_finetune_warm_start_refuses_a_folder_without_encoder_pth(tmp_path):
    opt = parse_options(ARGS + ["--no_cuda", "--load_weights_folder", str(tmp_path)])
    with pytest.raises(FileNotFoundError, match="ckpt_to_pth"):
        FinetuneTrainer(opt, [None], epochs=1)


@pytest.mark.parametrize("cli", ["finetune_metric_depth", "evaluate_metric_depth"])
def test_metric_clis_need_a_card_without_no_cuda(cli_run, cli, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in cli_run["common"] if a != "--no_cuda"]
    if cli == "finetune_metric_depth":
        argv += [str(cli_run["best"].parents[3] / "ft_args.txt")]
    else:
        argv += ["--checkpoint_path", str(cli_run["best"])]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        {"finetune_metric_depth": finetune_metric_depth,
         "evaluate_metric_depth": evaluate_metric_depth}[cli].main(argv)


REPO = Path(__file__).resolve().parents[1]
PARSE_CASES = {
    "model+inc_kitti": [str(REPO / "args_files/hisfog/kitti/resnet_320x1024.txt"),
                        str(REPO / "args_files/hisfog/ft/inc_kitti.txt")],
    "repo-native": ["--ft_lr", "3e-4", "--ft_batch_size", "2", "--max_depth", "10",
                    "--min_depth_eval", "0.1", "--garg_crop"],
    "reference-names": ["--lr", "3e-4", "--bs", "2", "--wd", "0.05", "--epochs", "3",
                        "--input_height", "64", "--min_depth", "0.01", "--do_kb_crop",
                        "--eigen_crop", "--height", "64"],
}


@pytest.mark.parametrize("case", list(PARSE_CASES))
def test_parse_ft_matches_jax(case):
    got_ns, got_rest = finetune_metric_depth.parse_ft(PARSE_CASES[case])
    want_ns, want_rest = jax_finetune_metric_depth.parse_ft(PARSE_CASES[case])
    assert vars(got_ns) == vars(want_ns)
    assert got_rest == want_rest
    if case != "repo-native":
        assert "--min_depth" in got_rest  # not taken for --min_depth_eval
    assert parse_options(got_rest).max_depth == jax_parse_options(want_rest).max_depth
