"""The port's eval step and depth inference against the JAX package's, on
the same weights and batch, in float32 on the CPU.

The tiny model of ``tests/test_torch_train_step.py`` (ResNet-18,
num_features 64, model_dim 16, patch 4, 16 queries, 16 bins, 64x96,
batch 2, SSIM weight 0.85, automasking), weights drawn with numpy into the
JAX variable tree and carried to the port by ``from_jax_variables``. The
JAX side is ``make_eval_step`` / ``make_infer_fn`` on the eval-mode
models (BatchNorm on its running statistics, no dropout, no rng); the port
runs its train bundle through ``make_eval_step`` / ``make_infer_fn``,
which put it in eval mode for the call. Held, with the train step test's
forward tolerance:

  * the losses, to 1e-5 relative;
  * the depth map, to 1e-5 of its largest value (the JAX resize is an
    interpolation-matrix product, the port's ``F.interpolate``);
  * ``make_infer_fn``'s depth, likewise;
  * the eval step leaves the BatchNorm statistics alone and every module
    in train mode, so a train step after it equals one without it, bit
    for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmnext_tpu.config import parse_options as jax_parse_options
from sfmnext_tpu.data.synthetic import make_batch
from sfmnext_tpu.training.builder import build_models as jax_build_models, init_params
from sfmnext_tpu.training.step import (make_eval_step as jax_make_eval_step,
                                       make_infer_fn as jax_make_infer_fn)
from sfmnext_tpu_torch.config import parse_options
from sfmnext_tpu_torch.training.builder import build_models
from sfmnext_tpu_torch.training.step import (make_eval_step, make_infer_fn, make_optimizer,
                                             make_train_step)
from sfmnext_tpu_torch.utils.jax_weights import from_jax_variables
from test_torch_models import _one_thread, numpy_variables  # noqa: F401
from test_torch_train_step import ARGS

LOSS_RTOL = 1e-5
DEPTH_TOL = 1e-5  # of the largest depth


def _port_models(variables, opt):
    models = build_models(opt, "cpu", train=True)
    for name, sd in from_jax_variables(variables).items():
        getattr(models, name).load_state_dict(sd, strict=True)
    return models


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def case():
    jax_opt = jax_parse_options(ARGS)
    jax_models = jax_build_models(jax_opt, train=False)
    variables = numpy_variables(lambda key: init_params(jax_opt, jax_models, key), 11)
    batch = make_batch(2, 64, 96, seed=5)
    batch.pop("depth_gt")
    metrics, outputs = jax_make_eval_step(jax_opt, jax_models)(
        variables["params"], variables["batch_stats"], batch)
    return dict(opt=parse_options(ARGS), variables=variables, batch=batch,
                jax_metrics={k: float(v) for k, v in metrics.items()},
                jax_depth=np.asarray(outputs["depth"]), jax_opt=jax_opt, jax_models=jax_models)


@pytest.fixture(scope="module")
def port_eval(case):
    models = _port_models(case["variables"], case["opt"])
    metrics, outputs = make_eval_step(case["opt"], models)(_torch(case["batch"]))
    return models, metrics, outputs


@pytest.mark.parametrize("key", ["loss", "loss/reprojection", "loss/smooth"])
def test_eval_losses_match_jax(case, port_eval, key):
    _, metrics, _ = port_eval
    np.testing.assert_allclose(metrics[key].item(), case["jax_metrics"][key], rtol=LOSS_RTOL)


def test_eval_depth_matches_jax(case, port_eval):
    _, _, outputs = port_eval
    got, want = outputs["depth"].numpy(), case["jax_depth"]
    assert got.shape == want.shape == (2, 64, 96, 1)
    assert np.abs(got - want).max() <= DEPTH_TOL * np.abs(want).max()


def test_infer_fn_matches_jax(case):
    images = np.random.RandomState(12).rand(2, 64, 96, 3).astype(np.float32)
    want = np.asarray(jax_make_infer_fn(case["jax_opt"], case["jax_models"])(
        case["variables"]["params"], case["variables"]["batch_stats"], jnp.asarray(images)))
    models = _port_models(case["variables"], case["opt"])
    got = make_infer_fn(case["opt"], models)(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (2, 64, 96, 1)
    assert np.abs(got - want).max() <= DEPTH_TOL * np.abs(want).max()
    assert all(m.training for mod in models.modules().values() for m in mod.modules())


def _state(models):
    return {f"{name}.{k}": v.clone() for name, mod in models.modules().items()
            for k, v in mod.state_dict().items()}


def test_train_step_after_eval_step_is_unchanged(case):
    """Two bundles from the same weights take one train step each; one of
    them runs the eval step first. The eval step moves no BatchNorm
    statistic and leaves every module in train mode, so the two end equal."""
    opt = dataclasses.replace(case["opt"], scheduler_step_size=15)
    batch = _torch(case["batch"])
    ends = []
    for with_eval in (False, True):
        models = _port_models(case["variables"], opt)
        step = make_train_step(opt, models, *make_optimizer(opt, models, steps_per_epoch=10))
        if with_eval:
            before = _state(models)
            make_eval_step(opt, models)(batch)
            after = _state(models)
            assert all(torch.equal(before[k], after[k]) for k in before)
            assert all(m.training for mod in models.modules().values() for m in mod.modules())
        torch.manual_seed(3)  # the transformer's dropout
        metrics = step(batch, torch.Generator().manual_seed(4))
        ends.append((metrics["loss"].item(), _state(models)))
    (loss_a, state_a), (loss_b, state_b) = ends
    assert loss_a == loss_b
    assert all(torch.equal(state_a[k], state_b[k]) for k in state_a)
