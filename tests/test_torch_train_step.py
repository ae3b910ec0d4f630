"""The port's training step against the JAX package's, on the same weights
and batch, in float32 on the CPU.

A tiny model (ResNet-18, num_features 64, model_dim 16, patch 4, 16
queries, 16 bins, 64x96, batch 2) with the flagship loss (SSIM weight
0.85, automasking): weights drawn with numpy into the JAX variable tree
and carried to the port by ``from_jax_variables``; the batch is
``data/synthetic.py``'s. The port takes its fused route
(``ssim_kernel.reprojection_min``, whose CPU path is the kernels' plain
versions), the JAX package on the CPU its XLA route. Dropout is off on
both sides (the JAX decoder cloned with ``deterministic=True``, the port's
dropout modules in eval mode) and so is the tie-break noise
(``rng=None``). Held against ``jax.value_and_grad(pipeline.forward)``:

  * the loss and its two terms, to 1e-5 relative;
  * every parameter's gradient, to 1e-3 of its norm (the per-pixel min
    and the bilinear floors make the loss piecewise smooth: a coordinate
    or a loss gap within float32 rounding of a kink can move one pixel's
    share);
  * the BatchNorm running statistics after the step, to 1e-5 relative:
    flax moves the running variance towards the *biased* batch variance;
  * the parameters after Adam steps fed the JAX gradients, against
    ``make_optimizer(...).update``, across the step-LR boundary and with
    ``--diff_lr``, to 1e-6 relative;
  * the other loss routes (``--disable_automasking`` through
    ``ssim_kernel.reprojection_losses``, ``--no_ssim``, ``--avg_reprojection``
    without automasking) give the plain route's loss (``use_pallas`` off),
    and ``--avg_reprojection`` with automasking, which needs TPU kernel #8,
    raises;
  * ``make_train_step(augment=True)`` takes a finite step with a generator
    and raises without one.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from sfmnext_tpu.config import parse_options as jax_parse_options
from sfmnext_tpu.data.synthetic import make_batch
from sfmnext_tpu.training import pipeline as jax_pipeline
from sfmnext_tpu.training.builder import build_models as jax_build_models, init_params
from sfmnext_tpu.training.step import make_optimizer as jax_make_optimizer
from sfmnext_tpu_torch.config import parse_options
from sfmnext_tpu_torch.training import pipeline
from sfmnext_tpu_torch.training.builder import build_models
from sfmnext_tpu_torch.training.step import make_optimizer, make_train_step
from sfmnext_tpu_torch.utils import torch_export
from sfmnext_tpu_torch.utils.jax_weights import from_jax_variables
from test_torch_models import numpy_variables

ARGS = ["--num_layers", "18", "--num_features", "64", "--model_dim", "16",
        "--patch_size", "4", "--query_nums", "16", "--dim_out", "16",
        "--height", "64", "--width", "96", "--batch_size", "2",
        "--compute_dtype", "float32", "--scheduler_step_size", "1"]
EXPORTS = {
    "encoder": lambda tree, stats: torch_export.export_resnet_encoder_decoder(
        tree, stats["encoder"]),
    "depth": lambda tree, stats: torch_export.export_sql_decoder(tree),
    "pose": lambda tree, stats: torch_export.export_pose_cnn(tree),
}


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
    return {k: np.asarray(v) for k, v in EXPORTS[name](tree, stats).items()
            if ".running_" not in k}


@pytest.fixture(scope="module")
def step():
    jax_opt = jax_parse_options(ARGS)
    opt = parse_options(ARGS)
    jax_models = jax_build_models(jax_opt, train=True)
    jax_models = dataclasses.replace(
        jax_models, depth=jax_models.depth.clone(deterministic=True))
    variables = numpy_variables(lambda key: init_params(jax_opt, jax_models, key), 7)
    batch = make_batch(2, 64, 96, seed=3)
    batch.pop("depth_gt")

    def loss_fn(params):
        return jax_pipeline.forward(jax_models, params, variables["batch_stats"],
                                    batch, None, jax_opt)

    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])

    models = _port_models(variables, opt)
    total, port_aux = pipeline.forward(
        models, {k: torch.from_numpy(v) for k, v in batch.items()}, opt)
    total.backward()
    return dict(jax_opt=jax_opt, opt=opt, variables=variables, loss=loss, aux=aux,
                grads=jax.tree_util.tree_map(np.asarray, grads), models=models,
                total=total, port_aux=port_aux)


@pytest.mark.parametrize("key", ["loss", "loss/reprojection", "loss/smooth"])
def test_loss_matches_jax(step, key):
    got = step["port_aux"]["metrics"][key].item()
    expect = float(step["aux"]["metrics"][key])
    np.testing.assert_allclose(got, expect, rtol=1e-5)


@pytest.mark.parametrize("name", ["encoder", "depth", "pose"])
def test_gradients_match_jax(step, name):
    expect = _named(name, step["grads"][name], step["variables"]["batch_stats"])
    got = {k: p.grad for k, p in getattr(step["models"], name).named_parameters()}
    assert sorted(got) == sorted(expect)
    for k, g in got.items():
        e = expect[k]
        err = np.linalg.norm(g.numpy() - e)
        # + 1e-9: a convolution bias ahead of a BatchNorm has a gradient that
        # is zero but for rounding (1e-12 here)
        assert err <= 1e-3 * np.linalg.norm(e) + 1e-9, (k, err, np.linalg.norm(e))


def test_batchnorm_statistics_match_jax(step):
    new_stats = jax.tree_util.tree_map(np.asarray, step["aux"]["batch_stats"])
    params = step["variables"]["params"]
    expect = torch_export.export_resnet_encoder_decoder(params["encoder"], new_stats["encoder"])
    got = step["models"].encoder.state_dict()
    keys = [k for k in expect if ".running_" in k]
    assert len(keys) == 2 * 28  # 20 BatchNorms in ResNet-18, 8 in the decoder
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), expect[k], rtol=1e-5, atol=1e-6, err_msg=k)
    # torch's own update (unbiased variance) would miss by var / (n - 1)
    old = torch_export.export_resnet_encoder_decoder(
        params["encoder"], step["variables"]["batch_stats"]["encoder"])
    k = "decoder.up4._net.4.running_var"
    assert not np.allclose(old[k], expect[k], rtol=1e-3)


@pytest.mark.parametrize("diff_lr", [False, True])
def test_adam_steps_match_optax(step, diff_lr):
    """Two Adam steps on the JAX gradients; the step-LR boundary (one
    epoch of one step) falls between them. optax sees each module's
    parameters as one flat vector (Adam is elementwise, and ``--diff_lr``
    labels by module), which keeps its CPU dispatch short."""
    jax_opt = dataclasses.replace(step["jax_opt"], diff_lr=diff_lr)
    opt = dataclasses.replace(step["opt"], diff_lr=diff_lr)
    variables, grads = step["variables"], step["grads"]
    stats = variables["batch_stats"]

    def flat(tree_of):
        return {name: np.concatenate([v.ravel() for _, v in
                                      sorted(_named(name, tree_of[name], stats).items())])
                for name in EXPORTS}

    tx = jax_make_optimizer(jax_opt, steps_per_epoch=1)
    params, flat_grads = flat(variables["params"]), flat(grads)
    state = tx.init(params)
    for _ in range(2):
        updates, state = tx.update(flat_grads, state, params)
        params = optax.apply_updates(params, updates)

    models = _port_models(variables, opt)
    adam, scheduler = make_optimizer(opt, models, steps_per_epoch=1)
    for _ in range(2):
        for name in EXPORTS:
            g = _named(name, grads[name], stats)
            for k, p in getattr(models, name).named_parameters():
                p.grad = torch.from_numpy(g[k].copy())
        adam.step()
        scheduler.step()
    for name in EXPORTS:
        got = np.concatenate([p.detach().numpy().ravel() for _, p in
                              sorted(getattr(models, name).named_parameters())])
        np.testing.assert_allclose(got, np.asarray(params[name]), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def _batch():
    return {k: torch.from_numpy(v) for k, v in make_batch(2, 64, 96, seed=3).items()
            if k != "depth_gt"}


@pytest.mark.parametrize("flags", [["--disable_automasking"], ["--no_ssim"],
                                   ["--avg_reprojection", "--disable_automasking"]], ids=" ".join)
def test_loss_routes_match_the_plain_route(step, flags):
    totals = []
    for use_pallas in (True, False):
        opt = dataclasses.replace(parse_options(ARGS + flags), use_pallas=use_pallas)
        total, _ = pipeline.forward(_port_models(step["variables"], opt), _batch(), opt)
        totals.append(total.item())
    np.testing.assert_allclose(totals[0], totals[1], rtol=1e-6)


def test_avg_reprojection_with_automasking_raises(step):
    opt = parse_options(ARGS + ["--avg_reprojection"])
    with pytest.raises(NotImplementedError, match="#8"):
        pipeline.forward(_port_models(step["variables"], opt), _batch(), opt)


def test_augmented_step_needs_a_generator():
    opt = parse_options(ARGS)
    models = build_models(opt, "cpu", train=True)
    step = make_train_step(opt, models, *make_optimizer(opt, models, 10), augment=True)
    batch = _batch()
    with pytest.raises(ValueError):
        step(batch)
    metrics = step(batch, torch.Generator().manual_seed(0))
    assert np.isfinite(metrics["loss"].item())
