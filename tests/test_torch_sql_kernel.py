"""The port's SQL kernel wrappers and plain ops against the JAX package.

On CPU tensors ``sfmnext_tpu_torch.ops.sql_kernel`` runs the kernels' plain
versions, so these pin what the Hopper kernels are held to on the card:
  * the JAX Pallas kernels (interpret mode) at tests/test_sql_kernel.py's
    shapes and tolerances (bf16, rounded at different points);
  * the JAX plain ops ``sfmnext_tpu.ops.sql_attention`` in float32, where
    both sides compute the same f32 arithmetic (atol 1e-5, and rtol 1e-6
    for depths up to 80);
  * the wrappers' input checks, and their launch counters staying 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sfmnext_tpu.ops import sql_attention as jax_sql
from sfmnext_tpu.ops.pallas import sql_kernel as jax_kernel
from sfmnext_tpu_torch.ops import sql_attention, sql_kernel

B, H, W, E, Q, D = 2, 16, 128, 32, 16, 24


def _data(seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, H, W, E).astype(np.float32)
    queries = (rng.randn(B, Q, E) * 0.3).astype(np.float32)
    w = (rng.randn(Q, D) * 0.2).astype(np.float32)
    b = (rng.randn(D) * 0.1).astype(np.float32)
    centers = np.sort(1.0 + 79.0 * rng.rand(B, D).astype(np.float32), axis=1)
    return feats, queries, w, b, centers


def _torch_args(feats, queries, w, b, centers):
    """The wrappers' operand dtypes: bf16 features/queries/W, f32 rest."""
    bf16 = torch.bfloat16
    return (torch.from_numpy(feats).to(bf16), torch.from_numpy(queries).to(bf16),
            torch.from_numpy(w).to(bf16), torch.from_numpy(b),
            torch.from_numpy(centers))


def test_summary_matches_pallas_interpret():
    feats, queries, *_ = _data(0)
    with pltpu.force_tpu_interpret_mode():
        expect = jax_kernel.sql_summary(jnp.asarray(feats), jnp.asarray(queries))
    got = sql_kernel.sql_summary(*_torch_args(*_data(0))[:2])
    assert got.dtype == torch.float32 and got.shape == (B, Q, E)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=0, atol=2e-2)


def test_depth_matches_pallas_interpret():
    args = _data(1)
    with pltpu.force_tpu_interpret_mode():
        expect = jax_kernel.sql_depth(*map(jnp.asarray, args))
    got = sql_kernel.sql_depth(*_torch_args(*args))
    assert got.dtype == torch.float32 and got.shape == (B, H, W, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=2e-2, atol=2e-2)


def test_full_query_matches_jax_f32():
    feats, queries, *_ = _data(2)
    e_jax, s_jax = jax_sql.sql_full_query(jnp.asarray(feats), jnp.asarray(queries))
    e_pt, s_pt = sql_attention.sql_full_query(
        torch.from_numpy(feats), torch.from_numpy(queries)
    )
    np.testing.assert_allclose(e_pt.numpy(), np.asarray(e_jax), rtol=0, atol=1e-5)
    np.testing.assert_allclose(s_pt.numpy(), np.asarray(s_jax), rtol=0, atol=1e-5)


def test_bins_to_depth_matches_jax_f32():
    feats, queries, w, b, centers = _data(3)
    energy, _ = jax_sql.sql_full_query(jnp.asarray(feats), jnp.asarray(queries))
    expect = jax_sql.sql_bins_to_depth(
        energy, jnp.asarray(w), jnp.asarray(b), jnp.asarray(centers)
    )
    got = sql_attention.sql_bins_to_depth(
        torch.from_numpy(np.array(energy)), torch.from_numpy(w),
        torch.from_numpy(b), torch.from_numpy(centers),
    )
    # depths reach 80, where one float32 ulp is 7.6e-6: a few ulps of the
    # sum's order on top of the absolute 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=1e-6, atol=1e-5)


# Inputs the kernels do not take, as edits of the good (feats, queries, w,
# bias, centers); the first five are features/queries faults that
# sql_summary rejects too.
BAD_INPUTS = {
    "f32_feats": lambda a: (a[0].float(),) + a[1:],
    "strided_feats": lambda a: (a[0].transpose(1, 2).contiguous().transpose(1, 2),) + a[1:],
    "e_not_multiple_of_8": lambda a: (a[0][..., :12].contiguous(),
                                      a[1][..., :12].contiguous()) + a[2:],
    "batch_mismatch": lambda a: (a[0], a[1][:1].contiguous()) + a[2:],
    "too_many_queries": lambda a: (a[0], a[1].repeat(1, 9, 1)) + a[2:],
    "w_rows": lambda a: a[:2] + (a[2][:-1].contiguous(),) + a[3:],
    "bias_bf16": lambda a: a[:3] + (a[3].to(torch.bfloat16),) + a[4:],
    "centers_shape": lambda a: a[:4] + (a[4][:, :-1].contiguous(),),
}
SUMMARY_FAULTS = list(BAD_INPUTS)[:5]


@pytest.mark.parametrize("fault", list(BAD_INPUTS))
def test_wrappers_reject_what_the_kernels_do_not_take(fault):
    args = BAD_INPUTS[fault](_torch_args(*_data(4)))
    with pytest.raises(ValueError):
        sql_kernel.sql_depth(*args)
    if fault in SUMMARY_FAULTS:
        with pytest.raises(ValueError):
            sql_kernel.sql_summary(*args[:2])


def test_cpu_calls_launch_no_kernel():
    before = (sql_kernel.sql_summary.launches, sql_kernel.sql_depth.launches)
    args = _torch_args(*_data(5))
    sql_kernel.sql_summary(*args[:2])
    sql_kernel.sql_depth(*args)
    assert (sql_kernel.sql_summary.launches, sql_kernel.sql_depth.launches) == before == (0, 0)
