"""The port's geometry and warp against the JAX package's, on the CPU.

  * ``ops/geometry.py`` and ``ops/warp.py`` (``grid_sample`` in border
    mode, ``warp_frame``) against ``sfmnext_tpu.ops.geometry`` and
    ``sfmnext_tpu.ops.warp`` in float32: the same arithmetic, to 1e-5
    (pixel coordinates up to ~100 carry float32 rounding of ~1e-5);
  * ``ops/warp_kernel.warp_border``, whose CPU path is the kernels' plain
    version, against ``warp_border_pallas`` in interpret mode at
    tests/test_pallas_warp.py's first shape and near-identity coordinates,
    with a unit-scale cotangent: output and coordinate gradients to 1e-5,
    that file's forward tolerance; the source image gets no gradient on
    either side;
  * the wrapper's input checks and its launch counters staying 0.
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sfmnext_tpu.ops import geometry as jax_geometry, warp as jax_warp
from sfmnext_tpu.ops.pallas.warp_kernel import warp_border_pallas
from sfmnext_tpu_torch.ops import geometry, warp, warp_kernel


def _poses(seed, b=3):
    rng = np.random.RandomState(seed)
    return ((rng.randn(b, 3) * 0.05).astype(np.float32),
            (rng.randn(b, 3) * 0.2).astype(np.float32))


def _camera(b, h, w):
    K = np.array([[0.58 * w, 0, 0.5 * w, 0], [0, 1.92 * h, 0.5 * h, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    K = np.broadcast_to(K, (b, 4, 4)).copy()
    return K, np.linalg.inv(K).astype(np.float32)


def _close(got, expect, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(expect), rtol=0, atol=atol)


@pytest.mark.parametrize("invert", [False, True])
def test_transformation_matches_jax(invert):
    aa, t = _poses(0)
    expect = jax_geometry.transformation_from_parameters(aa, t, invert=invert)
    got = geometry.transformation_from_parameters(
        torch.from_numpy(aa), torch.from_numpy(t), invert=invert)
    _close(got, expect, 1e-6)
    _close(geometry.rot_from_axisangle(torch.from_numpy(aa)),
           jax_geometry.rot_from_axisangle(aa), 1e-6)
    _close(geometry.get_translation_matrix(torch.from_numpy(t)),
           jax_geometry.get_translation_matrix(t), 0)


def test_backproject_and_project_match_jax():
    b, h, w = 2, 12, 20
    rng = np.random.RandomState(1)
    depth = (5 + 20 * rng.rand(b, h, w, 1)).astype(np.float32)
    K, inv_K = _camera(b, h, w)
    aa, t = _poses(2, b)
    T = np.array(jax_geometry.transformation_from_parameters(aa, t))
    _close(geometry.pixel_grid(h, w), jax_geometry.pixel_grid(h, w), 0)
    pts_jax = jax_geometry.backproject_depth(depth, inv_K)
    pts = geometry.backproject_depth(torch.from_numpy(depth), torch.from_numpy(inv_K))
    _close(pts, pts_jax, 1e-5)
    _close(geometry.project_3d(pts, torch.from_numpy(K), torch.from_numpy(T), h, w),
           jax_geometry.project_3d(pts_jax, K, T, h, w), 1e-5)


@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_matches_jax(align_corners):
    rng = np.random.RandomState(3)
    img = rng.rand(2, 10, 14, 3).astype(np.float32)
    grid = (rng.rand(2, 7, 9, 2) * 2.4 - 1.2).astype(np.float32)  # some outside
    expect = jax_warp.grid_sample(img, grid, "border", align_corners)
    got = warp.grid_sample(torch.from_numpy(img), torch.from_numpy(grid),
                           align_corners=align_corners)
    _close(got, expect, 1e-6)


def test_warp_frame_and_its_gradient_match_jax():
    b, h, w = 2, 16, 24
    rng = np.random.RandomState(4)
    src = rng.rand(b, h, w, 3).astype(np.float32)
    depth = (5 + 20 * rng.rand(b, h, w, 1)).astype(np.float32)
    K, inv_K = _camera(b, h, w)
    aa, t = _poses(5, b)

    def jax_loss(depth, aa, t):
        T = jax_geometry.transformation_from_parameters(aa, t)
        warped, _ = jax_warp.warp_frame(src, depth, inv_K, K, T)
        return (warped ** 2).sum(), warped

    (_, expect), expect_grads = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True))(depth, aa, t)
    args = [torch.from_numpy(a).requires_grad_() for a in (depth, aa, t)]
    T = geometry.transformation_from_parameters(args[1], args[2])
    got, _ = warp.warp_frame(torch.from_numpy(src), args[0], torch.from_numpy(inv_K),
                             torch.from_numpy(K), T)
    (got ** 2).sum().backward()
    _close(got.detach(), expect, 1e-5)
    for a, e in zip(args, expect_grads):
        e = np.asarray(e)
        _close(a.grad / np.abs(e).max(), e / np.abs(e).max(), 1e-4)


def _near_identity_coords(b, h, w, seed, max_dx=30, max_dy=4):
    """tests/test_pallas_warp.py's near-identity warp, as pixel coords."""
    rng = np.random.RandomState(seed)
    fy, fx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    disp = (rng.rand(2, b, h, w) - 0.5) * 2
    return ((fy + max_dy * disp[0]).astype(np.float32),
            (fx + max_dx * disp[1]).astype(np.float32))


def test_warp_border_matches_pallas_interpret():
    b, h, w, c = 2, 32, 128, 3
    img = np.random.RandomState(1).rand(b, h, w, c).astype(np.float32)
    fy, fx = _near_identity_coords(b, h, w, 0)
    cot = np.random.RandomState(2).randn(b, h, w, c).astype(np.float32)

    def loss(img, fy, fx):
        return (warp_border_pallas(img, fy, fx) * cot).sum()

    with pltpu.force_tpu_interpret_mode():
        expect = warp_border_pallas(img, fy, fx)
        expect_grads = jax.grad(loss, argnums=(0, 1, 2))(img, fy, fx)

    img_t = torch.from_numpy(img).requires_grad_()
    fy_t, fx_t = (torch.from_numpy(a).requires_grad_() for a in (fy, fx))
    got = warp_kernel.warp_border(img_t, fy_t, fx_t)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got.detach(), expect, 1e-5)
    assert img_t.grad is None and not np.asarray(expect_grads[0]).any()
    _close(fy_t.grad, expect_grads[1], 1e-5)
    _close(fx_t.grad, expect_grads[2], 1e-5)
    # the backward launcher's CPU path gives the same coordinate gradient
    dfy, dfx = warp_kernel.warp_border_bwd(torch.from_numpy(img), torch.from_numpy(fy),
                                           torch.from_numpy(fx), torch.from_numpy(cot))
    _close(dfy, expect_grads[1], 1e-5)
    _close(dfx, expect_grads[2], 1e-5)


BAD_INPUTS = {
    "f64_image": lambda a: (a[0].double(),) + a[1:],
    "strided_coords": lambda a: (a[0], a[1].transpose(1, 2).contiguous().transpose(1, 2), a[2]),
    "coords_shape": lambda a: a[:2] + (a[2][:, :-1].contiguous(),),
    "one_row_image": lambda a: (a[0][:, :1].contiguous(),) + a[1:],
}


@pytest.mark.parametrize("fault", list(BAD_INPUTS))
def test_warp_wrapper_rejects_what_the_kernels_do_not_take(fault):
    img = torch.rand(2, 8, 12, 3)
    fy, fx = (torch.from_numpy(a) for a in _near_identity_coords(2, 8, 12, 1, 3, 1))
    with pytest.raises(ValueError):
        warp_kernel.warp_border(*BAD_INPUTS[fault]((img, fy, fx)))


def test_cpu_warps_launch_no_kernel():
    img = torch.rand(1, 8, 12, 3)
    fy, fx = (torch.from_numpy(a).requires_grad_() for a in _near_identity_coords(1, 8, 12, 2, 3, 1))
    warp_kernel.warp_border(img, fy, fx).sum().backward()
    assert (warp_kernel.warp_border.launches, warp_kernel.warp_border_bwd.launches) == (0, 0)
