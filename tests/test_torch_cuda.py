"""The port's Hopper kernels against their plain versions, on the card.

Each test needs a CUDA card and skips without one. The JAX package's test
setup (tests/conftest.py) imports JAX, which the card's machine lacks, so
run these there with:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Shapes cover the flagship decoder, a ragged N, and the SQL widths the
argfiles use (Q 64/120/128, D 64/100/128, E 32/56/64/128), which the
kernels pad to their tile sizes; forward tolerances are those of the JAX
package's Pallas-vs-XLA tests (tests/test_sql_kernel.py). The backward
kernels, at every one of those shapes, round where their plain versions
round and sum in another order: each output within 1e-2 of its largest
value, as tests/test_torch_sql_kernel.py holds the plain versions to the
Pallas kernels. They sum across blocks in a fixed order, without atomics,
so two calls on the same inputs give the same bits. The warp kernels compute the plain version's float32
arithmetic (contracted into FMAs), in border and zeros padding: outputs,
coordinate and image gradients to 1e-5 of their largest value (the image
gradient adds with float32 atomics, in another order on every run), at the
steps' shapes and at the layouts the kernels treat apart: C other than 1
and 3, output planes other than the image's, a ragged tail of pixels, a
batch of 3 at an odd Ho*Wo (batches starting off a 16-byte boundary),
coordinates far outside the image, smooth and widely scattered samples;
the image gradient also on inputs chosen for each of its two per-tile
branches (a corner box staged in shared memory, or direct adds), a mix of
both, every sample on one point, and boxes clipped at every image edge.
The summary forward is held at the main paths' shapes (batch 1, 4 and 8,
the indoor N, E = 56 and 128, Q = 120, a ragged N), its residuals m and z
against the plain version's, and two calls give the same bits.

The SSIM kernels (flagship B=8, 320x1024, 2 warped and 2 identity
sources; ragged shapes with H, W off the 16x32 tile, H = 4, 3 sources)
sum the 7x7 windows in another order than the plain average pool, with
FMAs: the variance E[p^2] - mu^2 cancels against the 9e-4 constant, so
the maps agree to 1e-4 (float32 and bf16 inputs alike: both sides round
the inputs the same way). The min agrees to 1e-4 and its argument
wherever the winner leads by more than 2e-4; an identity equal to a warped
source takes every tie, so that source never wins and gets no gradient.
The forwards are also held where a pixel's maps leave as one 16-byte
vector (N = 4) or value by value (N = 3), on tiles whose halo rows are
read as vectors (W % 4 == 0) down to H = 4, with and without noise; they
have no atomics, so two calls give the same bits, and at the flagship
shape their one-wave grids walk several tiles a block.
The backward divides by the squared SSIM denominator, which amplifies the
summation-order differences: its gradients agree to 1e-3 of their largest
value in float32, and to 1e-2 with bf16 rounding (one bf16 step), also
at widths off its 32-column tiles and 16-byte vectors (W = 1025, 9, 70,
134), at H = 4 and with 1 and 8 sources; it has no atomics, so two calls
give the same bits. The depth forward is also held at the main paths' shapes
(serving batch 1, indoor 64 bins, E = 128). The
jitter kernel computes the plain float32 formulas with FMAs, hue's
quotients by the hardware's reciprocal: 1e-5, at the flagship stack, a
ragged frame, frames smaller than a cluster's blocks or one block's
threads, 65,537 frames, contrast at each position of the order, and hue
on its sector boundaries; a sample without jitter is copied bit for bit,
and two calls give the same bits.
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


# (B, H, W, Q, E, D) where the summary forward runs on the main paths:
# serving batch 1, the flagship step (B 8), the indoor decoder (N 27,648),
# the resnet18_lite decoder (Q 120, E 128), and a ragged N at batch 8
SUMMARY_PATH_SHAPES = [
    (1, 160, 512, 128, 32, 128),
    (8, 160, 512, 128, 32, 128),
    (8, 144, 192, 128, 32, 64),
    (12, 96, 320, 120, 128, 128),
    (8, 37, 53, 120, 56, 64),
]


@pytest.mark.parametrize("shape", SHAPES + SUMMARY_PATH_SHAPES, ids=str)
def test_summary_kernel_matches_plain(dev, shape):
    feats, queries, *_ = _inputs(dev, shape, 0)
    before = sql_kernel.sql_summary.launches
    got = sql_kernel.sql_summary(feats, queries)
    torch.cuda.synchronize()
    assert sql_kernel.sql_summary.launches == before + 1
    want = sql_attention.sql_full_query(feats, queries)[1]
    torch.testing.assert_close(got, want, rtol=0, atol=2e-2)


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[1], SHAPES[3], SHAPES[4]]
                         + SUMMARY_PATH_SHAPES[:3], ids=str)
def test_summary_residuals_match_plain(dev, shape):
    """The backward pass's residuals: m, the true max of the energies over
    all pixels (float32 sums of bf16 products, in another order: 1e-4), and
    z, the sum of exp(energy - m) (the chunks' partial sums rescaled and
    added, exp2 in hardware: 1e-4 relative)."""
    feats, queries, *_ = _inputs(dev, shape, 10)
    out, m, z = sql_kernel.sql_summary_fwd(feats, queries)
    torch.cuda.synchronize()
    want_out, want_m, want_z = sql_attention.sql_summary_fwd(feats, queries)
    torch.testing.assert_close(out, want_out, rtol=0, atol=2e-2)
    torch.testing.assert_close(m, want_m, rtol=0, atol=1e-4)
    torch.testing.assert_close(z, want_z, rtol=1e-4, atol=0)


@pytest.mark.parametrize("shape", [SHAPES[0], SUMMARY_PATH_SHAPES[0], SHAPES[4]], ids=str)
def test_summary_kernel_is_deterministic(dev, shape):
    """Two calls of the summary forward agree bit for bit: the chunks'
    partials merge in a fixed order, without atomics."""
    feats, queries, *_ = _inputs(dev, shape, 11)
    first = sql_kernel.sql_summary_fwd(feats, queries)
    second = sql_kernel.sql_summary_fwd(feats, queries)
    torch.cuda.synchronize()
    for a, x in zip(first, second):
        assert torch.equal(a, x)


# (B, H, W, Q, E, D) where the depth forward runs on the main paths: a
# serving request at batch 1, the indoor decoder (64 bins), the
# resnet18_lite decoder at E = 128
DEPTH_PATH_SHAPES = [
    (1, 160, 512, 128, 32, 128),
    (8, 144, 192, 128, 32, 64),
    (12, 96, 320, 120, 128, 128),
]


@pytest.mark.parametrize("shape", SHAPES + DEPTH_PATH_SHAPES, ids=str)
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


def _assert_scaled(got, want, tol):
    """Within tol of want's largest value, plus 1e-5 for an output that is
    exactly zero in the plain version (with one bin the softmax has no
    gradient; the kernel's fused multiply-adds leave rounding there)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max()) + 1e-5, err


@pytest.mark.parametrize("shape", SHAPES, ids=str)
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


@pytest.mark.parametrize("shape", SHAPES, ids=str)
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


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[4]], ids=str)
def test_bwd_kernels_are_deterministic(dev, shape):
    """Two calls of each backward kernel on the same inputs agree bit for
    bit: the cross-block sums run in a fixed order."""
    feats, queries, w, bias, centers = _inputs(dev, shape, 8)
    b, h, wd, q, e, _ = shape
    gen = torch.Generator(device=dev).manual_seed(9)
    out, m, z = sql_attention.sql_summary_fwd(feats, queries)
    g = torch.randn(b, q, e, device=dev, generator=gen)
    delta = (g * out).sum(-1)
    gd = torch.randn(b, h, wd, 1, device=dev, generator=gen)
    for run in (lambda: sql_kernel.sql_summary_bwd(feats, queries, g, m, z, delta),
                lambda: sql_kernel.sql_depth_bwd(feats, queries, w, bias, centers, gd)):
        first, second = run(), run()
        torch.cuda.synchronize()
        for a, x in zip(first, second):
            assert torch.equal(a, x)


def _check_warp(img, fy, fx, gout, zeros):
    """Each warp kernel launches once and agrees with autograd of the plain
    sample: output, coordinate and image gradient to 1e-5 of their largest
    value."""
    mode = "zeros" if zeros else "border"
    kernels = (warp_kernel.warp_fwd, warp_kernel.warp_bwd, warp_kernel.warp_bwd_img)
    before = [fn.launches[mode] for fn in kernels]
    out = warp_kernel.warp_fwd(img, fy, fx, zeros)
    dfy, dfx = warp_kernel.warp_bwd(img, fy, fx, gout, zeros)
    dimg = warp_kernel.warp_bwd_img(fy, fx, gout, img.shape, zeros)
    torch.cuda.synchronize()
    assert [fn.launches[mode] for fn in kernels] == [n + 1 for n in before]
    img_p = img.clone().requires_grad_()
    fy_p, fx_p = fy.clone().requires_grad_(), fx.clone().requires_grad_()
    want = (warp.sample_zeros if zeros else warp.sample_border)(img_p, fy_p, fx_p)
    want_dimg, want_dfy, want_dfx = torch.autograd.grad(want, (img_p, fy_p, fx_p), gout)
    _assert_scaled(out, want.detach(), 1e-5)
    _assert_scaled(dfy, want_dfy, 1e-5)
    _assert_scaled(dfx, want_dfx, 1e-5)
    # the image gradient sums with atomics, in another order on every run
    _assert_scaled(dimg, want_dimg, 1e-5)


def _off_border(fy, fx, h, w):
    """None exactly on the border, where the kernel's strict border mask
    (warp_kernel.py:246-253) and autograd's clamp give different gradients."""
    fy = torch.where((fy == 0) | (fy == h - 1), fy + 0.25, fy)
    fx = torch.where((fx == 0) | (fx == w - 1), fx + 0.25, fx)
    return fy, fx


@pytest.mark.parametrize("zeros", [False, True], ids=["border", "zeros"])
@pytest.mark.parametrize("shape", [(8, 320, 1024, 3), (8, 288, 384, 1), (2, 37, 53, 3),
                                   (1, 2, 2, 1)], ids=str)
def test_warp_kernels_match_plain(dev, shape, zeros):
    b, h, w, c = shape
    gen = torch.Generator(device=dev).manual_seed(7)
    img = torch.rand(b, h, w, c, device=dev, generator=gen)
    base_y, base_x = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                                    torch.arange(w, device=dev, dtype=torch.float32),
                                    indexing="ij")
    # near-identity with a margin past every border
    fy = base_y + 8 * (torch.rand(b, h, w, device=dev, generator=gen) - 0.5) * 2
    fx = base_x + 40 * (torch.rand(b, h, w, device=dev, generator=gen) - 0.5) * 2
    fy, fx = _off_border(fy, fx, h, w)
    gout = torch.randn(b, h, w, c, device=dev, generator=gen)
    _check_warp(img, fy, fx, gout, zeros)


# (B, H, W, C, Ho, Wo, coordinates): the kernels take 4 output pixels a
# thread (consecutive in border padding, 32 apart in zeros padding), C = 1
# and 3 as template instances and any other C in a loop, and 16-byte vectors
# only where 4 consecutive pixels start on a multiple of 4 of the flat pixel
# index
WARP_LAYOUTS = {
    "C=2": (2, 9, 13, 2, 9, 13, "scattered"),
    "C=4": (2, 9, 13, 4, 9, 13, "scattered"),
    "C=5, Ho*Wo=35": (1, 5, 7, 5, 5, 7, "scattered"),
    "Ho*Wo=35, a ragged tail": (2, 5, 7, 3, 5, 7, "scattered"),
    "HoxWo=17x23 from 40x60": (2, 40, 60, 3, 17, 23, "scattered"),
    "HoxWo=70x50 from 40x60, C=1": (2, 40, 60, 1, 70, 50, "scattered"),
    "B=3 at Ho*Wo=143": (3, 11, 13, 3, 11, 13, "smooth"),
    "B=3 at Ho*Wo=143, C=1": (3, 11, 13, 1, 11, 13, "smooth"),
    "far, +-1e30": (3, 11, 13, 3, 11, 13, "far"),
    "far, +-1e30, C=1": (2, 8, 12, 1, 8, 12, "far"),
    "smooth, 96x160": (2, 96, 160, 3, 96, 160, "smooth"),
    "wide jitter, 96x160": (2, 96, 160, 3, 96, 160, "wide"),
}


@pytest.mark.parametrize("zeros", [False, True], ids=["border", "zeros"])
@pytest.mark.parametrize("layout", list(WARP_LAYOUTS))
def test_warp_kernels_match_plain_on_other_layouts(dev, layout, zeros):
    b, h, w, c, ho, wo, coords = WARP_LAYOUTS[layout]
    gen = torch.Generator(device=dev).manual_seed(len(layout))
    img = torch.rand(b, h, w, c, device=dev, generator=gen)
    u = lambda: 2 * torch.rand(b, ho, wo, device=dev, generator=gen) - 1
    if coords == "scattered":  # anywhere in the image and 3 pixels past it
        fy, fx = (h - 1) / 2 + (h + 5) / 2 * u(), (w - 1) / 2 + (w + 5) / 2 * u()
    else:
        ys, xs = torch.meshgrid(torch.arange(ho, device=dev, dtype=torch.float32),
                                torch.arange(wo, device=dev, dtype=torch.float32),
                                indexing="ij")
        dy, dx = (8, 40) if coords == "wide" else (1.5, 2.5)
        fy, fx = ys + dy * u(), xs + dx * u()
    if coords == "far":  # some far outside the image, either side
        far = torch.rand(b, ho, wo, device=dev, generator=gen)
        fy = torch.where(far < 0.2, torch.full_like(fy, 1e30), fy)
        fx = torch.where(far > 0.8, torch.full_like(fx, -1e30), fx)
    fy, fx = _off_border(fy, fx, h, w)
    gout = torch.randn(b, ho, wo, c, device=dev, generator=gen)
    _check_warp(img, fy.contiguous(), fx.contiguous(), gout, zeros)


# warp_bwd_img's tiles of output pixels (a warp takes a row of one), the
# box past which a warp's samples count as scattered, and the largest corner
# box a tile stages in shared memory (csrc/warp_kernel.cu): a scattered
# warp adds straight into the image gradient; at C > 1 the other warps of a
# tile stage in shared memory where their box holds at most 2x the tile's
# pixels and fits the staging floats, else (and at C = 1) they add directly
IMG_TILE = (8, 32)
IMG_WARP_BOX_PX = 8 * IMG_TILE[1]
IMG_BOX_PX = 2 * IMG_TILE[0] * IMG_TILE[1]


def _staged_tiles(fy, fx, h, w, c, zeros):
    """Per output tile: True where warp_bwd_img stages a corner box, False
    where every sample that touches the image adds directly, None where no
    sample touches the image."""
    if zeros:
        y0, x0 = fy.floor(), fx.floor()
    else:
        y0 = fy.clamp(0, h - 1).floor().clamp(0, h - 2)
        x0 = fx.clamp(0, w - 1).floor().clamp(0, w - 2)
    hit = (y0 >= -1) & (y0 <= h - 1) & (x0 >= -1) & (x0 <= w - 1)  # a corner inside
    b, ho, wo = fy.shape
    th, tw = IMG_TILE
    pad = (0, -wo % tw, 0, -ho % th)
    big = float(2**30)

    def per_warp(v, fill, reduce):  # [B, tiles_y, warps (tile rows), tiles_x]
        v = torch.nn.functional.pad(torch.where(hit, v, torch.full_like(v, fill)), pad, value=fill)
        return reduce(v.reshape(b, v.shape[1] // th, th, v.shape[2] // tw, tw), dim=4)

    box = [per_warp(y0.clamp(min=0), big, torch.amin), per_warp((y0 + 1).clamp(max=h - 1), -big, torch.amax),
           per_warp(x0.clamp(min=0), big, torch.amin), per_warp((x0 + 1).clamp(max=w - 1), -big, torch.amax)]
    touched = (box[0] <= box[1]).any(dim=2)
    scattered = (box[0] <= box[1]) & ((box[1] - box[0] + 1) * (box[3] - box[2] + 1) > IMG_WARP_BOX_PX)
    lo_y, hi_y, lo_x, hi_x = (torch.where(scattered, torch.full_like(v, f), v).amin(dim=2) if f > 0
                              else torch.where(scattered, torch.full_like(v, f), v).amax(dim=2)
                              for v, f in zip(box, (big, -big, big, -big)))
    bh, bw = hi_y - lo_y + 1, hi_x - lo_x + 1
    stride = torch.div(bw * c + 6, 4, rounding_mode="floor") * 4
    staged = (lo_y <= hi_y) & (bh * bw <= IMG_BOX_PX) & (bh * stride <= min(IMG_BOX_PX * c, 12288))
    staged &= c > 1
    return [None if not t else bool(st) for t, st in zip(touched.flatten().tolist(),
                                                         staged.flatten().tolist())]


# (B, H, W, C, coordinates, the tiles' branch): smooth samples stage every
# tile's box at C > 1 and add directly at C = 1; samples jittered by 8 rows
# and 40 columns make every warp scatter (direct adds); a mix of both in
# one call, by tiles and by warps of one tile (these stage beside warps
# that add directly); every sample on one point (all adds on 4 pixels, in
# shared memory at C = 3 and in device memory at C = 1); samples stretched
# past every image edge (boxes clipped there, whole tiles outside in zeros
# padding) at H, W off the 8 x 32 tile; samples far outside; C = 1, 2 (the
# channel loop) and 3
IMG_GRAD_CASES = {
    "smooth, 8x288x384x3": (8, 288, 384, 3, "smooth", "staged"),
    "smooth, 2x288x384x1": (2, 288, 384, 1, "smooth", "direct"),
    "smooth, 2x70x150x2": (2, 70, 150, 2, "smooth", "staged"),
    "scattered, 2x288x384x3": (2, 288, 384, 3, "wide", "direct"),
    "scattered, 2x160x320x1": (2, 160, 320, 1, "wide", "direct"),
    "mixed, 2x96x320x3": (2, 96, 320, 3, "mixed", "both"),
    "mixed warps, 2x96x320x3": (2, 96, 320, 3, "rows", "staged"),
    "one point, 2x96x160x3": (2, 96, 160, 3, "point", "staged"),
    "one point, 1x37x53x1": (1, 37, 53, 1, "point", "direct"),
    "edges, 2x37x53x3": (2, 37, 53, 3, "edges", None),
    "edges, 3x70x150x1": (3, 70, 150, 1, "edges", None),
    "edges, 2x45x131x2": (2, 45, 131, 2, "edges", None),
    "far, 2x70x150x3": (2, 70, 150, 3, "far", None),
}


@pytest.mark.parametrize("zeros", [False, True], ids=["border", "zeros"])
@pytest.mark.parametrize("case", list(IMG_GRAD_CASES))
def test_image_gradient_on_both_branches(dev, case, zeros):
    b, h, w, c, coords, branch = IMG_GRAD_CASES[case]
    gen = torch.Generator(device=dev).manual_seed(len(case) + c)
    img = torch.rand(b, h, w, c, device=dev, generator=gen)
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32), indexing="ij")
    u = lambda: 2 * torch.rand(b, h, w, device=dev, generator=gen) - 1
    if coords == "point":
        fy, fx = torch.full_like(u(), 0.3 * h + 0.37), torch.full_like(u(), 0.6 * w + 0.21)
    elif coords == "edges":  # past every edge by up to 3 pixels
        fy, fx = ys * (h + 5) / (h - 1) - 2.5 + 0.4 * u(), xs * (w + 5) / (w - 1) - 2.5 + 0.4 * u()
    else:
        fy, fx = ys + 1.5 * u(), xs + 2.5 * u()
        wide = (ys + 8 * u(), xs + 40 * u())
        if coords == "wide":
            fy, fx = wide
        elif coords in ("mixed", "rows"):  # the right half or every other warp scattered
            far = xs >= w // 2 if coords == "mixed" else (ys // 2) % 2 == 1
            fy, fx = torch.where(far, wide[0], fy), torch.where(far, wide[1], fx)
        elif coords == "far":
            far = torch.rand(b, h, w, device=dev, generator=gen)
            fy = torch.where(far < 0.1, torch.full_like(fy, 1e30), fy)
            fx = torch.where(far > 0.9, torch.full_like(fx, -1e30), fx)
    fy, fx = _off_border(fy, fx, h, w)
    fy, fx = fy.contiguous(), fx.contiguous()
    tiles = _staged_tiles(fy, fx, h, w, c, zeros)
    if branch == "both":
        assert True in tiles and False in tiles
    elif branch:
        assert all(t == (branch == "staged") for t in tiles)
    gout = torch.randn(b, h, w, c, device=dev, generator=gen)
    _check_warp(img, fy, fx, gout, zeros)


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


# (B, H, W, warped sources, identity sources); the next five put widths off
# the backward's 32-column tiles and 16-byte vectors (W = 1025, 9, 70, 134),
# H below the 6-row halo, one and eight sources; the last two widths of
# 16-byte rows (the forwards copy their halos' rows as vectors), down to
# H = 4, where a pixel's 4 maps leave as one vector and 3 value by value
SSIM_SHAPES = [(8, 320, 1024, 2, 2), (2, 37, 53, 3, 3), (2, 4, 9, 3, 2), (1, 21, 70, 1, 1),
               (1, 6, 1025, 1, 1), (2, 4, 9, 8, 1), (1, 37, 1025, 8, 2), (3, 4, 70, 1, 1),
               (2, 21, 134, 2, 1), (2, 70, 160, 4, 1), (1, 4, 136, 3, 2)]
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


@pytest.mark.parametrize("routed", [True, False], ids=["routed", "per-source"])
def test_ssim_bwd_kernel_is_deterministic(dev, routed):
    """Two calls of the backward on the same inputs agree bit for bit: no
    atomics, every sum in a fixed order."""
    b, h, w, n, m = SSIM_SHAPES[0]
    preds, idents, target, noise = _ssim_inputs(dev, b, h, w, n, m, seed=5)
    gen = torch.Generator(device=dev).manual_seed(6)
    if routed:
        maps = ssim_kernel.ssim_fwd(preds, target)
        _, arg = ssim_kernel.ssim_ident_min(idents, target, noise, maps)
        g = torch.randn(b, h, w, device=dev, generator=gen)
    else:
        arg, g = None, torch.randn(b, h, w, n, device=dev, generator=gen)
    first = ssim_kernel.ssim_bwd(preds, target, g, arg)
    second = ssim_kernel.ssim_bwd(preds, target, g, arg)
    torch.cuda.synchronize()
    for a, x in zip(first, second):
        assert torch.equal(a, x)


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


@pytest.mark.parametrize("shape", [SSIM_SHAPES[0], SSIM_SHAPES[1]], ids=str)
def test_ssim_forwards_are_deterministic(dev, shape):
    """Two calls of each forward on the same inputs agree bit for bit."""
    preds, idents, target, noise = _ssim_inputs(dev, *shape, seed=7)
    runs = []
    for _ in range(2):
        maps = ssim_kernel.ssim_fwd(preds, target)
        runs.append((maps, *ssim_kernel.ssim_ident_min(idents, target, noise, maps)))
    torch.cuda.synchronize()
    for a, x in zip(*runs):
        assert torch.equal(a, x)


def test_ssim_forwards_walk_tiles_in_one_wave(dev):
    """At the flagship shape the tiles outnumber a wave of blocks several
    times over, so each block of the forwards' grid takes many tiles."""
    b, h, w, n, m = SSIM_SHAPES[0]
    rows, cols = ssim_kernel.FWD_TILE
    tiles = b * -(-h // rows) * -(-w // cols)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    index = torch.cuda.current_device()
    for kernel, count in (("ssim_fwd", n), ("ssim_ident_min", m)):
        wave = ssim_kernel.blocks_per_sm(kernel, count, index) * sms
        assert tiles > 4 * wave, (kernel, tiles, wave)


@pytest.mark.parametrize("with_noise", [True, False], ids=["noise", "no-noise"])
@pytest.mark.parametrize("shape", [SSIM_SHAPES[0], SSIM_SHAPES[1], (2, 70, 160, 2, 2)], ids=str)
def test_ssim_ident_min_matches_plain(dev, shape, with_noise):
    """The min to 1e-4 and its argument on the pixels whose winner leads by
    more than 2e-4, with the tie-break noise and without it."""
    preds, idents, target, noise = _ssim_inputs(dev, *shape, seed=11)
    noise = noise if with_noise else None
    maps = ssim_kernel.ssim_fwd(preds, target)
    out_min, arg = ssim_kernel.ssim_ident_min(idents, target, noise, maps)
    torch.cuda.synchronize()
    want_min, want_arg = ssim_kernel.plain_ident_min(idents, target, noise, maps)
    torch.testing.assert_close(out_min, want_min, rtol=0, atol=SSIM_MAP_TOL)
    ident = ssim_kernel.plain_maps(idents, target)
    cands = torch.cat([ident if noise is None else ident + noise, maps], dim=-1)
    top2 = cands.topk(2, dim=-1, largest=False).values
    clear = top2[..., 1] - top2[..., 0] > 2 * SSIM_MAP_TOL
    assert bool(clear.any())
    assert bool((arg == want_arg)[clear].all())


def _jitter_inputs(dev, b, f, h, w, seed=4):
    """A stack in [0, 1] and draws with contrast first in sample 0 and last
    in sample 1, every third sample left unjittered."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    color = torch.rand(b, f, h, w, 3, device=dev, generator=gen)
    order, factors, _ = augment.jitter_params(gen, b)
    order[0] = torch.tensor([1, 0, 2, 3], device=dev, dtype=torch.int32)  # contrast first
    if b > 1:
        order[1] = torch.tensor([3, 2, 0, 1], device=dev, dtype=torch.int32)  # contrast last
    do_jit = torch.arange(b, device=dev) % 3 != 2  # mixed
    return color, order, factors, do_jit


# (B, F, H, W): the flagship stack; a ragged frame (H*W % 4 != 0, pixels
# one at a time); frames of fewer 4-pixel groups than a cluster has blocks,
# and of fewer than one block has threads; B*F = 65,537 frames of 4x5
JITTER_SHAPES = [(8, 3, 320, 1024), (2, 3, 37, 53), (3, 1, 4, 5), (2, 2, 24, 40),
                 (65537, 1, 4, 5)]


@pytest.mark.parametrize("shape", JITTER_SHAPES, ids=str)
def test_jitter_kernel_matches_plain(dev, shape):
    color, order, factors, do_jit = _jitter_inputs(dev, *shape)
    before = jitter_kernel.color_jitter.launches
    got = jitter_kernel.color_jitter(color, order, factors, do_jit)
    torch.cuda.synchronize()
    assert jitter_kernel.color_jitter.launches == before + 1
    want = jitter_kernel.plain_color_jitter(color, order, factors, do_jit)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(got[~do_jit], color[~do_jit])


@pytest.mark.parametrize("at", range(4))
def test_jitter_contrast_at_each_position(dev, at):
    """Contrast at position ``at`` of every sample's order: the mean is taken
    after the ops before it, on frames the cluster's blocks share."""
    b = 6
    color, _, factors, do_jit = _jitter_inputs(dev, b, 3, 96, 160, seed=at)
    others = torch.tensor([[0, 2, 3], [3, 2, 0], [2, 0, 3]], dtype=torch.int32)
    rows = [others[i % 3].tolist() for i in range(b)]
    order = torch.tensor([r[:at] + [1] + r[at:] for r in rows], device=dev, dtype=torch.int32)
    got = jitter_kernel.color_jitter(color, order, factors, do_jit)
    torch.cuda.synchronize()
    want = jitter_kernel.plain_color_jitter(color, order, factors, do_jit)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert torch.equal(got[~do_jit], color[~do_jit])


@pytest.mark.parametrize("shape", [JITTER_SHAPES[0], JITTER_SHAPES[1]], ids=str)
def test_jitter_kernel_is_deterministic(dev, shape):
    """Two calls agree bit for bit (the frame's mean is summed in a fixed
    order), each one launch; skipped samples are copied bit for bit."""
    color, order, factors, do_jit = _jitter_inputs(dev, *shape, seed=9)
    runs = []
    for _ in range(2):
        before = jitter_kernel.color_jitter.launches
        runs.append(jitter_kernel.color_jitter(color, order, factors, do_jit))
        assert jitter_kernel.color_jitter.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0][~do_jit], color[~do_jit])


def test_jitter_grid_is_one_wave_of_clusters(dev):
    """At the flagship frame the clusters fit the card at once and keep
    most of each block's span in shared memory between the two phases."""
    clusters, kept, chunks = jitter_kernel.grid(320, 1024, torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert 1 <= clusters and clusters * jitter_kernel.CLUSTER <= sms
    assert 0.9 * chunks <= kept <= chunks


def test_jitter_hue_at_sector_boundaries(dev):
    """Hue alone (the other factors 1) on pixels whose hue sits on a sector
    boundary of the HSV round trip (two channels equal, or a grey), shifted
    by 0, +-1/6 and 0.1: the kernel's quotients hold the plain version's to
    1e-5 where floor(h * 6) decides the sector."""
    gen = torch.Generator(device=dev).manual_seed(13)
    b, h, w = 4, 64, 96
    color = torch.rand(b, 1, h, w, 3, device=dev, generator=gen)
    rows = torch.arange(h, device=dev) % 4
    r, g, bl = color.unbind(-1)
    g = torch.where(rows[:, None] == 0, r, g)   # r = g: sector 0 | 1 (or 3 | 4)
    bl = torch.where(rows[:, None] == 1, g, bl)  # g = b: sector 2 | 3 (or 5 | 0)
    bl = torch.where(rows[:, None] == 2, r, bl)  # r = b: sector 4 | 5 (or 1 | 2)
    g = torch.where(rows[:, None] == 3, r, g)    # grey
    bl = torch.where(rows[:, None] == 3, r, bl)
    color = torch.stack([r, g, bl], dim=-1).contiguous()
    order = torch.tensor([[3, 0, 1, 2], [0, 3, 2, 1], [2, 1, 3, 0], [1, 2, 0, 3]], device=dev,
                         dtype=torch.int32)
    factors = torch.ones(b, 4, device=dev)
    factors[:, 3] = torch.tensor([0.0, 1 / 6, -1 / 6, 0.1], device=dev)
    do_jit = torch.ones(b, dtype=torch.bool, device=dev)
    got = jitter_kernel.color_jitter(color, order, factors, do_jit)
    torch.cuda.synchronize()
    want = jitter_kernel.plain_color_jitter(color, order, factors, do_jit)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
