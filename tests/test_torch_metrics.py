"""The port's depth metrics (``sfmnext_tpu_torch/ops/metrics.py``) and its
train-time ``train_depth_metrics`` against the JAX package's, on
numpy-drawn depths, to 1e-6 relative (float32 arithmetic in another order);
the crop masks exactly.

``train_depth_metrics`` is held against the jitted JAX function (one
compile: every case has the same shapes) with the depth resized from
16x24 to the GT's 20x30, on maps whose masked count is even, odd, or cut
by many GT zeros: the median scaling takes the lower median of the masked
values, as the JAX package's padded sort does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmnext_tpu.ops import metrics as jax_metrics
from sfmnext_tpu.training.pipeline import train_depth_metrics as jax_train_depth_metrics
from sfmnext_tpu_torch.ops import metrics
from sfmnext_tpu_torch.training.pipeline import train_depth_metrics
from test_torch_models import _one_thread  # noqa: F401

RTOL = 1e-6


def _depths(seed, shape=(2, 20, 30)):
    rng = np.random.RandomState(seed)
    gt = rng.uniform(1.0, 60.0, shape).astype(np.float32)
    pred = (gt * rng.uniform(0.7, 1.4, shape)).astype(np.float32)
    return gt, pred


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize("as_torch", [False, True], ids=["numpy", "torch"])
def test_compute_depth_errors(as_torch):
    gt, pred = _depths(0, (500,))
    if as_torch:
        got = metrics.compute_depth_errors(torch.from_numpy(gt), torch.from_numpy(pred))
        want = jax_metrics.compute_depth_errors(jnp.asarray(gt), jnp.asarray(pred))
        got = [g.item() for g in got]
    else:
        got = metrics.compute_depth_errors(gt, pred)
        want = jax_metrics.compute_depth_errors(gt, pred)
    _close(got, [float(w) for w in want])


def test_compute_depth_errors_masked():
    gt, pred = _depths(1)
    mask = np.random.RandomState(2).rand(*gt.shape) < 0.6
    got = metrics.compute_depth_errors_masked(
        torch.from_numpy(gt), torch.from_numpy(pred), torch.from_numpy(mask))
    want = jax_metrics.compute_depth_errors_masked(jnp.asarray(gt), jnp.asarray(pred),
                                                   jnp.asarray(mask))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k].item(), float(want[k]))


def test_compute_metric_depth_errors():
    gt, pred = _depths(3, (400,))
    got = metrics.compute_metric_depth_errors(gt, pred)
    want = jax_metrics.compute_metric_depth_errors(gt, pred)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("hw", [(375, 1242), (192, 640), (37, 53)])
def test_crop_masks(hw):
    np.testing.assert_array_equal(metrics.eigen_crop_mask(*hw), jax_metrics.eigen_crop_mask(*hw))
    np.testing.assert_array_equal(metrics.garg_crop_mask(*hw), jax_metrics.garg_crop_mask(*hw))


@pytest.mark.parametrize("as_torch", [False, True], ids=["numpy", "torch"])
def test_flip_postprocess(as_torch):
    rng = np.random.RandomState(4)
    disp, disp_flipped = rng.rand(2, 2, 6, 40).astype(np.float32)
    want = np.asarray(jax_metrics.flip_postprocess(disp, disp_flipped))
    if as_torch:
        got = metrics.flip_postprocess(torch.from_numpy(disp), torch.from_numpy(disp_flipped))
        got = got.numpy()
    else:
        got = metrics.flip_postprocess(disp, disp_flipped)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


def test_median_scale():
    gt, pred = _depths(5, (301,))
    _close(metrics.median_scale(gt, pred), jax_metrics.median_scale(gt, pred))


@pytest.fixture(scope="module")
def jax_depth_metrics():
    return jax.jit(jax_train_depth_metrics)


def _gt_case(case):
    """[2,20,30,1] GT depths: the garg crop keeps 11 x 27 pixels an image,
    594 in all (even); "odd" zeroes one of them, "zeros" about a third of
    every image (some outside the crop)."""
    rng = np.random.RandomState(6)
    gt = rng.uniform(2.0, 70.0, (2, 20, 30, 1)).astype(np.float32)
    if case == "odd":
        gt[1, 12, 10, 0] = 0.0
    elif case == "zeros":
        gt[rng.rand(*gt.shape) < 0.33] = 0.0
    return gt


@pytest.mark.parametrize("case", ["even", "odd", "zeros"])
def test_train_depth_metrics_matches_jax(jax_depth_metrics, case):
    gt = _gt_case(case)
    mask = (gt > 0)[:, 8:19, 1:28]
    assert mask.sum() % 2 == (case == "odd") or case == "zeros"
    depth = np.random.RandomState(7).uniform(0.5, 90.0, (2, 16, 24, 1)).astype(np.float32)
    want = jax_depth_metrics(jnp.asarray(depth), jnp.asarray(gt))
    got = train_depth_metrics(torch.from_numpy(depth), torch.from_numpy(gt))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k].item(), float(want[k]))


def test_masked_median_is_the_lower_median():
    from sfmnext_tpu_torch.training.pipeline import _masked_median

    x = torch.tensor([[5.0, 1.0], [4.0, 2.0]])
    assert _masked_median(x, torch.tensor([[True, True], [True, True]])).item() == 2.0
    assert _masked_median(x, torch.tensor([[True, True], [False, True]])).item() == 2.0
    assert _masked_median(x, torch.zeros(2, 2, dtype=torch.bool)).item() == float("inf")
