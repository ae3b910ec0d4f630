"""The port's indoor training step against the JAX package's, on the same
weights and batch, in float32 on the CPU.

A tiny model (ResNet-18, num_features 64, model_dim 16, patch 4, 16
queries, 16 bins, 64x96, batch 2, max depth 10, ``nyu_raw``) with the
indoor argfile's loss: the RectifyNet and the occlusion-weighted
min-reprojection (``--use_improved_mini_reproj_loss``). Weights are drawn
with numpy into the JAX variable tree and carried to the port by
``from_jax_variables``; the batch is ``data/synthetic.py``'s with ``K3x3``.
The port's warps take their kernels' wrapper (``warp_sample``, whose CPU
path is the plain samples), the JAX package on the CPU its XLA
``grid_sample``. Dropout and the tie-break noise are off on both sides.
Held against ``jax.value_and_grad(indoor.forward_indoor)``:

  * the loss and each of its terms, to 1e-5 relative; ``loss/rc``, the
    mean |rot3 - rot1| of two rotations that differ by a tenth of their
    size, to 1e-4 (JAX's own float32 and float64 runs differ by 3.6e-5
    there);
  * each module's gradient, as one vector, to a fraction of its norm set
    by how far float32 itself carries it at these weights: the port's
    float32 gradient differs from its own float64 gradient by 1.6e-3
    (encoder), 7.5e-4 (depth), 1.8e-4 (pose) and 2.0e-2 (rectify). The
    loss is piecewise smooth (the min, the |depth - depth| of the L1 term
    where the two near-constant depths of random weights cross, the
    bilinear floors), and the RectifyNet's gradient is the small
    remainder after its BatchNorms remove the mean of a gradient that the
    decoder's spatial mean spreads evenly. Limits: 5e-3 for the encoder,
    depth and pose nets, 5e-2 for the RectifyNet;
  * the encoder's and the RectifyNet's BatchNorm running statistics after
    the step (threaded through the target and reference passes, and the
    six RectifyNet calls), to 1e-4 of each tensor's largest value;
  * two accumulated micro-steps (``--accumulation_steps 2``, ``--diff_lr``)
    fed the JAX gradients and then a numpy-drawn tree, against
    ``optax.MultiSteps`` of the JAX ``make_optimizer``, to 1e-6: nothing
    moves after the first, the averaged gradient moves everything after
    the second, the pose and rectify nets at a tenth of the rate.

``--use_photo_geo_loss`` costs a second JAX compile of the whole step
(about 30 s), so its loss, ``photo_and_geometry_loss_imp``, is held to
the JAX function on the same tensors (values and cotangents), and the
port's step under it runs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sfmnext_tpu.config import parse_options as jax_parse_options
from sfmnext_tpu.data.synthetic import make_batch
from sfmnext_tpu.training import indoor as jax_indoor
from sfmnext_tpu.training.builder import build_models as jax_build_models, init_params
from sfmnext_tpu.training.step import make_optimizer as jax_make_optimizer
from sfmnext_tpu_torch.config import parse_options
from sfmnext_tpu_torch.training import indoor
from sfmnext_tpu_torch.training.builder import build_models
from sfmnext_tpu_torch.training.step import Accumulation, make_optimizer, select_pipeline
from sfmnext_tpu_torch.utils import torch_export
from sfmnext_tpu_torch.utils.jax_weights import from_jax_variables
from test_torch_models import _one_thread, numpy_variables  # noqa: F401


ARGS = ["--num_layers", "18", "--num_features", "64", "--model_dim", "16",
        "--patch_size", "4", "--query_nums", "16", "--dim_out", "16",
        "--height", "64", "--width", "96", "--batch_size", "2", "--max_depth", "10",
        "--dataset", "nyu_raw", "--compute_dtype", "float32", "--use_rectify_net",
        "--use_improved_mini_reproj_loss", "--scheduler_step_size", "1"]
TERMS = ["loss", "loss/reprojection", "loss/l1_reg", "loss/smooth", "loss/rc", "loss/rt"]
GRAD_RTOL = {"encoder": 5e-3, "depth": 5e-3, "pose": 5e-3, "rectify": 5e-2}
N_OPTAX = 4096
EXPORTS = {
    "encoder": lambda tree, stats: torch_export.export_resnet_encoder_decoder(tree, stats),
    "depth": lambda tree, stats: torch_export.export_sql_decoder(tree),
    "pose": lambda tree, stats: torch_export.export_pose_cnn(tree),
    "rectify": lambda tree, stats: torch_export.export_rectify_net(tree, stats),
}


def _batch():
    batch = make_batch(2, 64, 96, seed=5)
    batch.pop("depth_gt")
    batch["K3x3"] = batch["K"][:, :3, :3].copy()
    return batch


def _port_models(variables, opt):
    models = build_models(opt, "cpu", train=True)
    for name, sd in from_jax_variables(variables).items():
        getattr(models, name).load_state_dict(sd, strict=True)
    for m in models.depth.modules():  # dropout off, BatchNorm still on batch stats
        if isinstance(m, (torch.nn.Dropout, torch.nn.MultiheadAttention)):
            m.eval()
    return models


def _named(name, tree, stats):
    """A JAX parameter tree under the port's parameter names."""
    return {k: np.asarray(v) for k, v in EXPORTS[name](tree, stats.get(name)).items()
            if ".running_" not in k}


@pytest.fixture(scope="module")
def ref():
    """The JAX loss, terms, gradients and statistics, and the port after
    one forward and backward on the same weights and batch."""
    jax_opt = jax_parse_options(ARGS)
    jax_models = jax_build_models(jax_opt, train=True)
    jax_models = dataclasses.replace(
        jax_models, depth=jax_models.depth.clone(deterministic=True))
    variables = numpy_variables(lambda key: init_params(jax_opt, jax_models, key), 11)
    batch = _batch()

    def loss_fn(params):
        return jax_indoor.forward_indoor(jax_models, params, variables["batch_stats"], batch,
                                         None, jax_opt)

    (_, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    opt = parse_options(ARGS)
    models = _port_models(variables, opt)
    total, port_aux = indoor.forward_indoor(
        models, {k: torch.from_numpy(v) for k, v in batch.items()}, opt)
    total.backward()
    return dict(variables=variables, opt=opt, models=models,
                metrics={k: float(v) for k, v in aux["metrics"].items()},
                grads=jax.tree_util.tree_map(np.asarray, grads),
                stats=jax.tree_util.tree_map(np.asarray, aux["batch_stats"]),
                port_metrics={k: v.item() for k, v in port_aux["metrics"].items()})


def test_select_pipeline_picks_the_indoor_forward():
    assert select_pipeline(parse_options(ARGS)) is indoor.forward_indoor
    outdoor = [a for a in ARGS[:12]]  # the model flags alone: KITTI, outdoor
    assert select_pipeline(parse_options(outdoor)) is not indoor.forward_indoor


@pytest.mark.parametrize("term", TERMS)
def test_indoor_loss_matches_jax(ref, term):
    rtol = 1e-4 if term == "loss/rc" else 1e-5
    np.testing.assert_allclose(ref["port_metrics"][term], ref["metrics"][term], rtol=rtol)


@pytest.mark.parametrize("name", list(GRAD_RTOL))
def test_indoor_gradients_match_jax(ref, name):
    expect = _named(name, ref["grads"][name], ref["variables"]["batch_stats"])
    named = dict(getattr(ref["models"], name).named_parameters())
    assert sorted(named) == sorted(expect)
    got = np.concatenate([named[k].grad.numpy().ravel() for k in sorted(expect)])
    want = np.concatenate([expect[k].ravel() for k in sorted(expect)])
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= GRAD_RTOL[name], (name, err)


@pytest.mark.parametrize("name", ["encoder", "rectify"])
def test_indoor_batchnorm_statistics_match_jax(ref, name):
    expect = EXPORTS[name](ref["variables"]["params"][name], ref["stats"][name])
    got = getattr(ref["models"], name).state_dict()
    keys = [k for k in expect if ".running_" in k]
    assert len(keys) == 2 * (28 if name == "encoder" else 20)
    old = EXPORTS[name](ref["variables"]["params"][name], ref["variables"]["batch_stats"][name])
    for k in keys:
        err = np.abs(got[k].numpy() - expect[k]).max()
        assert err <= 1e-4 * np.abs(expect[k]).max(), (k, err)
        assert not np.array_equal(old[k], expect[k]), k  # the step moved it


def test_accumulated_micro_steps_match_optax_multisteps(ref):
    """optax sees the first ``N_OPTAX`` entries of each module's parameters
    as one flat vector (Adam is elementwise and ``--diff_lr`` labels by
    module); the port steps every parameter."""
    flags = ["--accumulation_steps", "2", "--diff_lr"]
    jax_opt = jax_parse_options(ARGS + flags)
    opt = parse_options(ARGS + flags)
    variables, stats = ref["variables"], ref["variables"]["batch_stats"]
    rng = np.random.RandomState(12)
    grads = [{name: _named(name, ref["grads"][name], stats) for name in GRAD_RTOL}]
    grads.append({name: {k: (rng.randn(*g.shape) * g.std()).astype(np.float32)
                         for k, g in tree.items()} for name, tree in grads[0].items()})

    def flat(tree, n=None):
        return {name: np.concatenate([v.ravel() for _, v in sorted(tree[name].items())])[:n]
                for name in GRAD_RTOL}

    start = flat({name: _named(name, variables["params"][name], stats) for name in GRAD_RTOL})
    tx = jax_make_optimizer(jax_opt, steps_per_epoch=1)
    params = {name: v[:N_OPTAX] for name, v in start.items()}
    state, expected = tx.init(params), []
    for g in grads:
        updates, state = tx.update(flat(g, N_OPTAX), state, params)
        params = optax.apply_updates(params, updates)
        expected.append(params)

    models = _port_models(variables, opt)
    accumulation = Accumulation(*make_optimizer(opt, models, steps_per_epoch=1), every=2)
    for g, want, moves in zip(grads, expected, (False, True)):
        accumulation.zero_grad()
        for name in GRAD_RTOL:  # what a micro-step's backward adds
            for k, p in getattr(models, name).named_parameters():
                grad = torch.from_numpy(g[name][k].copy())
                p.grad = grad if p.grad is None else p.grad + grad
        assert accumulation.step() is moves
        for name in GRAD_RTOL:
            got = np.concatenate([p.detach().numpy().ravel() for _, p in
                                  sorted(getattr(models, name).named_parameters())])
            np.testing.assert_allclose(got[:N_OPTAX], np.asarray(want[name]), rtol=1e-6,
                                       atol=1e-7, err_msg=name)
            assert bool((got != start[name]).any()) is moves, name


def _photo_geo_inputs():
    """Inputs of photo_and_geometry_loss_imp: target, 2 raw references, 2
    warped ones (one with a zero border, as the rectified frames have),
    reference depths, their warps and the projected depths, [2,64,96,C]."""
    rng = np.random.RandomState(13)

    def img(c, lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, (2, 64, 96, c)).astype(np.float32)

    target = img(3)
    raw = [img(3), img(3)]
    warped = [np.clip(target + 0.2 * img(3, -1, 1), 0, 1), img(3)]
    warped[1][:, :, :6] = 0.0
    depths = [img(1, 1, 9) for _ in range(6)]
    return target, raw, warped, depths[:2], depths[2:4], depths[4:]


def test_photo_and_geometry_loss_matches_jax():
    target, raw, warped, d_ref, proj, com = _photo_geo_inputs()
    opt = parse_options(ARGS + ["--use_photo_geo_loss"])
    jax_opt = jax_parse_options(ARGS + ["--use_photo_geo_loss"])

    def jax_fn(warped, d_ref, proj, com):
        return jax_indoor.photo_and_geometry_loss_imp(target, raw, warped, d_ref, proj, com,
                                                      jax_opt)

    expect, vjp = jax.vjp(jax.jit(jax_fn), warped, d_ref, proj, com)
    expect_grads = vjp((jnp.float32(1.0), jnp.float32(0.5)))
    args = [[torch.from_numpy(a).requires_grad_() for a in group]
            for group in (warped, d_ref, proj, com)]
    photo, geo = indoor.photo_and_geometry_loss_imp(
        torch.from_numpy(target), [torch.from_numpy(r) for r in raw], *args, opt)
    (photo + 0.5 * geo).backward()
    np.testing.assert_allclose([photo.item(), geo.item()], np.asarray(expect), rtol=1e-5)
    assert photo.item() > 0 and geo.item() > 0
    for group, want_group in zip(args, expect_grads):
        for t, want in zip(group, want_group):
            want = np.asarray(want)
            # the projected depth only sets the detached weight 1 - d
            got = np.zeros_like(want) if t.grad is None else t.grad.numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_photo_geo_step_runs(ref):
    opt = parse_options(ARGS + ["--use_photo_geo_loss"])
    models = _port_models(ref["variables"], opt)
    total, aux = indoor.forward_indoor(
        models, {k: torch.from_numpy(v) for k, v in _batch().items()}, opt)
    total.backward()
    for term in ("loss/photo", "loss/geo", "loss/smooth", "loss/rc", "loss/rt"):
        assert np.isfinite(aux["metrics"][term].item()), term
    assert all(p.grad is not None for p in models.rectify.parameters())
