"""The port's Hopper kernels against their plain versions, on the card.

Each test needs a CUDA card and skips without one. The JAX package's test
setup (tests/conftest.py) imports JAX, which the card's machine lacks, so
run these there with:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Shapes cover the flagship decoder, a ragged N, and the SQL widths the
argfiles use (Q 64/120/128, D 64/100/128, E 32/56/64/128), which the
kernels pad to their tile sizes; forward tolerances are those of the JAX
package's Pallas-vs-XLA tests (tests/test_sql_kernel.py). The backward
kernels (E <= 64: the only argfile with E = 128 uses the resnet18_lite
backbone, which the port does not build) round where their plain versions
round and sum in another order: each output within 1e-2 of its largest
value, as tests/test_torch_sql_kernel.py holds the plain versions to the
Pallas kernels. The warp kernels compute the plain version's float32
arithmetic (contracted into FMAs): outputs and coordinate gradients to
1e-5 of their largest value.
"""

import pytest
import torch

from sfmnext_tpu_torch.device import disable_tf32
from sfmnext_tpu_torch.ops import sql_attention, sql_kernel, warp, warp_kernel

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


BWD_SHAPES = [shape for shape in SHAPES if shape[4] <= sql_kernel.MAX_E_BWD]


def _assert_scaled(got, want, tol):
    """Within tol of want's largest value, plus 1e-5 for an output that is
    exactly zero in the plain version (with one bin the softmax has no
    gradient; the kernel's fused multiply-adds leave rounding there)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max()) + 1e-5, err


@pytest.mark.parametrize("shape", BWD_SHAPES, ids=str)
def test_summary_bwd_kernel_matches_plain(dev, shape):
    feats, queries, *_ = _inputs(dev, shape, 3)
    b, _, _, q, e, _ = shape
    out, m, z = sql_attention.sql_summary_fwd(feats, queries)
    g = torch.randn(b, q, e, device=dev, generator=torch.Generator(device=dev).manual_seed(4))
    delta = (g * out).sum(-1)
    before = sql_kernel.sql_summary_bwd.launches
    got = sql_kernel.sql_summary_bwd(feats, queries, g, m, z, delta)
    torch.cuda.synchronize()
    assert sql_kernel.sql_summary_bwd.launches == before + 1
    want = sql_attention.sql_summary_bwd(feats, queries, g, m, z, delta)
    for a, w in zip(got, want):
        _assert_scaled(a, w, 1e-2)


@pytest.mark.parametrize("shape", BWD_SHAPES, ids=str)
def test_depth_bwd_kernel_matches_plain(dev, shape):
    args = _inputs(dev, shape, 5)
    b, h, w, *_ = shape
    g = torch.randn(b, h, w, 1, device=dev, generator=torch.Generator(device=dev).manual_seed(6))
    before = sql_kernel.sql_depth_bwd.launches
    got = sql_kernel.sql_depth_bwd(*args, g)
    torch.cuda.synchronize()
    assert sql_kernel.sql_depth_bwd.launches == before + 1
    want = sql_attention.sql_depth_bwd(*args, g)
    for a, w in zip(got, want):
        _assert_scaled(a, w, 1e-2)


@pytest.mark.parametrize("shape", [(8, 320, 1024, 3), (2, 37, 53, 3), (1, 2, 2, 1)], ids=str)
def test_warp_kernels_match_plain(dev, shape):
    b, h, w, c = shape
    gen = torch.Generator(device=dev).manual_seed(7)
    img = torch.rand(b, h, w, c, device=dev, generator=gen)
    base_y, base_x = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                                    torch.arange(w, device=dev, dtype=torch.float32),
                                    indexing="ij")
    # near-identity with a margin past every border
    fy = base_y + 8 * (torch.rand(b, h, w, device=dev, generator=gen) - 0.5) * 2
    fx = base_x + 40 * (torch.rand(b, h, w, device=dev, generator=gen) - 0.5) * 2
    gout = torch.randn(b, h, w, c, device=dev, generator=gen)
    before = (warp_kernel.warp_border.launches, warp_kernel.warp_border_bwd.launches)
    out = warp_kernel.warp_border_fwd(img, fy, fx)
    dfy, dfx = warp_kernel.warp_border_bwd(img, fy, fx, gout)
    torch.cuda.synchronize()
    assert (warp_kernel.warp_border.launches, warp_kernel.warp_border_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    fy_p, fx_p = fy.clone().requires_grad_(), fx.clone().requires_grad_()
    want = warp.sample_border(img, fy_p, fx_p)
    want_dfy, want_dfx = torch.autograd.grad(want, (fy_p, fx_p), gout)
    _assert_scaled(out, want.detach(), 1e-5)
    _assert_scaled(dfy, want_dfy, 1e-5)
    _assert_scaled(dfx, want_dfx, 1e-5)


def test_fused_ops_carry_gradients_on_the_card(dev):
    """The decoder's fused path differentiates through the kernels."""
    feats, queries, w, bias, centers = (t.requires_grad_() for t in _inputs(dev, SHAPES[1], 8))
    before = (sql_kernel.sql_summary_bwd.launches, sql_kernel.sql_depth_bwd.launches)
    loss = sql_kernel.sql_summary(feats, queries).sum() + sql_kernel.sql_depth(
        feats, queries, w, bias, centers).sum()
    loss.backward()
    torch.cuda.synchronize()
    assert (sql_kernel.sql_summary_bwd.launches, sql_kernel.sql_depth_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    for t in (feats, queries, w, bias, centers):
        assert t.grad is not None and bool(torch.isfinite(t.grad.float()).all())
