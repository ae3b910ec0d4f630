"""The port's Hopper kernels against their plain versions, on the card.

Each test needs a CUDA card and skips without one. The JAX package's test
setup (tests/conftest.py) imports JAX, which the card's machine lacks, so
run these there with:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Shapes cover the flagship decoder, a ragged N, and the SQL widths the
argfiles use (Q 64/120/128, D 64/100/128, E 32/56/64/128), which the
kernels pad to their tile sizes; tolerances are those of the JAX
package's Pallas-vs-XLA tests (tests/test_sql_kernel.py).
"""

import pytest
import torch

from sfmnext_tpu_torch.device import disable_tf32
from sfmnext_tpu_torch.ops import sql_attention, sql_kernel

pytestmark = pytest.mark.cuda

# (B, H, W, Q, E, D)
SHAPES = [
    (4, 160, 512, 128, 32, 128),  # flagship: 320x1024, N = 81,920
    (1, 37, 53, 128, 32, 128),    # ragged N at batch 1
    (2, 48, 160, 120, 64, 100),   # query_nums 120, model_dim 64, dim_out 100
    (2, 30, 50, 64, 56, 64),      # model_dim 56
    (2, 16, 64, 128, 128, 128),   # the largest E the kernels take
    (2, 16, 128, 16, 32, 24),     # tests/test_sql_kernel.py's shape
    (1, 3, 5, 1, 8, 1),           # one query, one bin, 15 pixels
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    disable_tf32()
    return torch.device("cuda")


def _inputs(dev, shape, seed):
    b, h, w, q, e, d = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=dev) * scale

    centers = 0.001 + 79.999 * torch.rand(b, d, generator=g, device=dev)
    return (randn(b, h, w, e).to(torch.bfloat16),
            randn(b, q, e, scale=0.3).to(torch.bfloat16),
            randn(q, d, scale=0.2).to(torch.bfloat16),
            randn(d, scale=0.1),
            torch.sort(centers, dim=1).values)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_summary_kernel_matches_plain(dev, shape):
    feats, queries, *_ = _inputs(dev, shape, 0)
    before = sql_kernel.sql_summary.launches
    got = sql_kernel.sql_summary(feats, queries)
    torch.cuda.synchronize()
    assert sql_kernel.sql_summary.launches == before + 1
    want = sql_attention.sql_full_query(feats, queries)[1]
    torch.testing.assert_close(got, want, rtol=0, atol=2e-2)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_depth_kernel_matches_plain(dev, shape):
    feats, queries, w, bias, centers = _inputs(dev, shape, 1)
    before = sql_kernel.sql_depth.launches
    got = sql_kernel.sql_depth(feats, queries, w, bias, centers)
    torch.cuda.synchronize()
    assert sql_kernel.sql_depth.launches == before + 1
    want = sql_attention.sql_bins_to_depth(
        sql_attention.sql_energy(feats, queries), w, bias, centers,
        compute_dtype=torch.bfloat16,
    )
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


def test_cuda_inputs_are_checked_not_diverted(dev):
    """A CUDA tensor the kernel does not take raises; it never falls back."""
    feats, queries, *_ = _inputs(dev, SHAPES[-1], 2)
    with pytest.raises(ValueError):
        sql_kernel.sql_summary(feats.float(), queries)
