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

The SSIM kernels (flagship B=8, 320x1024, 2 warped and 2 identity
sources; ragged shapes with H, W off the 16x32 tile, H = 4, 3 sources)
sum the 7x7 windows in another order than the plain average pool, with
FMAs: the variance E[p^2] - mu^2 cancels against the 9e-4 constant, so
the maps agree to 1e-4 (float32 and bf16 inputs alike: both sides round
the inputs the same way). The min agrees to 1e-4 and its argument
wherever the winner leads by more than 2e-4; an identity equal to a warped
source takes every tie, so that source never wins and gets no gradient.
The backward divides by the squared SSIM denominator, which amplifies the
summation-order differences: its gradients agree to 1e-3 of their largest
value in float32, and to 1e-2 with bf16 rounding (one bf16 step). The
jitter kernel computes the plain float32 formulas with FMAs: 1e-5; a
sample without jitter is copied bit for bit.
"""

import pytest
import torch

from sfmnext_tpu_torch.device import disable_tf32
from sfmnext_tpu_torch.data import augment
from sfmnext_tpu_torch.ops import (jitter_kernel, sql_attention, sql_kernel, ssim_kernel, warp,
                                   warp_kernel)

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


# (B, H, W, warped sources, identity sources)
SSIM_SHAPES = [(8, 320, 1024, 2, 2), (2, 37, 53, 3, 3), (2, 4, 9, 3, 2), (1, 21, 70, 1, 1)]
SSIM_MAP_TOL = 1e-4
LOSS_DTYPES = [torch.float32, torch.bfloat16]


def _ssim_inputs(dev, b, h, w, n, m, seed):
    """A target, warped sources near it, identity sources, noise."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    target = torch.rand(b, h, w, 3, device=dev, generator=gen)
    preds = [(target + 0.1 * (k + 1) * torch.randn(b, h, w, 3, device=dev, generator=gen))
             .clamp(0, 1) for k in range(n)]
    idents = [torch.rand(b, h, w, 3, device=dev, generator=gen) for _ in range(m)]
    noise = 1e-3 * torch.randn(1, h, w, m, device=dev, generator=gen)
    return preds, idents, target, noise


@pytest.mark.parametrize("loss_dtype", LOSS_DTYPES, ids=str)
@pytest.mark.parametrize("shape", SSIM_SHAPES, ids=str)
def test_ssim_kernels_match_plain(dev, shape, loss_dtype):
    preds, idents, target, noise = _ssim_inputs(dev, *shape, seed=sum(shape))
    before = (ssim_kernel.ssim_fwd.launches, ssim_kernel.ssim_ident_min.launches,
              ssim_kernel.ssim_bwd.launches)
    maps = ssim_kernel.ssim_fwd(preds, target, loss_dtype=loss_dtype)
    out_min, arg = ssim_kernel.ssim_ident_min(idents, target, noise, maps, loss_dtype=loss_dtype)
    gen = torch.Generator(device=dev).manual_seed(1)
    g = torch.randn(out_min.shape, device=dev, generator=gen)
    dps = ssim_kernel.ssim_bwd(preds, target, g, arg, loss_dtype=loss_dtype)
    g_maps = torch.randn(maps.shape, device=dev, generator=gen)
    dps_direct = ssim_kernel.ssim_bwd(preds, target, g_maps, None, loss_dtype=loss_dtype)
    torch.cuda.synchronize()
    assert (ssim_kernel.ssim_fwd.launches, ssim_kernel.ssim_ident_min.launches,
            ssim_kernel.ssim_bwd.launches) == (before[0] + 1, before[1] + 1, before[2] + 2)

    want_maps = ssim_kernel.plain_maps(preds, target, loss_dtype=loss_dtype)
    torch.testing.assert_close(maps, want_maps, rtol=0, atol=SSIM_MAP_TOL)
    want_min, want_arg = ssim_kernel.plain_ident_min(idents, target, noise, want_maps,
                                                     loss_dtype=loss_dtype)
    torch.testing.assert_close(out_min, want_min, rtol=0, atol=SSIM_MAP_TOL)
    cands = torch.cat([ssim_kernel.plain_maps(idents, target, loss_dtype=loss_dtype) + noise,
                       want_maps], dim=-1)
    top2 = cands.topk(2, dim=-1, largest=False).values
    clear = top2[..., 1] - top2[..., 0] > 2 * SSIM_MAP_TOL
    assert bool((arg == want_arg)[clear].all())

    # gradients under the plain routing where the two agree
    tol = 1e-3 if loss_dtype == torch.float32 else 1e-2
    want = ssim_kernel.plain_bwd(preds, target, g, arg, loss_dtype=loss_dtype)
    for a, w in zip(dps, want):
        _assert_scaled(a, w, tol)
    want = ssim_kernel.plain_bwd(preds, target, g_maps, None, loss_dtype=loss_dtype)
    for a, w in zip(dps_direct, want):
        _assert_scaled(a, w, tol)


@pytest.mark.parametrize("shape", [SSIM_SHAPES[0], SSIM_SHAPES[1]], ids=str)
def test_identity_takes_ties_on_the_card(dev, shape):
    """An identity source equal to warped source 0 takes every pixel that
    source would win: it never wins, and its gradient is zero."""
    preds, idents, target, _ = _ssim_inputs(dev, *shape, seed=3)
    idents[0] = preds[0]
    ps = [p.clone().requires_grad_() for p in preds]
    to_opt, automask = ssim_kernel.reprojection_min(ps, idents, target, None)
    to_opt.sum().backward()
    torch.cuda.synchronize()
    _, arg = ssim_kernel.ssim_ident_min(
        idents, target, None, ssim_kernel.ssim_fwd(preds, target))
    assert not bool((arg == 0).any())
    assert not bool(ps[0].grad.any())
    assert not bool(automask[arg == shape[3]].any())


@pytest.mark.parametrize("shape", [(8, 3, 320, 1024), (2, 3, 37, 53), (3, 1, 4, 5)], ids=str)
def test_jitter_kernel_matches_plain(dev, shape):
    b, f, h, w = shape
    gen = torch.Generator(device=dev).manual_seed(4)
    color = torch.rand(b, f, h, w, 3, device=dev, generator=gen)
    order, factors, _ = augment.jitter_params(gen, b)
    order[0] = torch.tensor([1, 0, 2, 3], device=dev, dtype=torch.int32)  # contrast first
    order[1] = torch.tensor([3, 2, 0, 1], device=dev, dtype=torch.int32)  # contrast last
    do_jit = torch.arange(b, device=dev) % 3 != 2  # mixed
    before = jitter_kernel.color_jitter.launches
    got = jitter_kernel.color_jitter(color, order, factors, do_jit)
    torch.cuda.synchronize()
    assert jitter_kernel.color_jitter.launches == before + 1
    want = jitter_kernel.plain_color_jitter(color, order, factors, do_jit)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(got[~do_jit], color[~do_jit])
