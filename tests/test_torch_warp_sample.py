"""The port's full-gradient warp and the indoor geometry against the JAX
package's, on the CPU.

  * ``ops/geometry.euler_to_mat`` and ``project_depth``, and
    ``ops/warp.inverse_rotation_warp`` (the RectifyNet warp, zeros padding)
    with its gradients, against ``sfmnext_tpu.ops``, to 1e-5 (pixel
    coordinates up to ~100 carry float32 rounding of ~1e-5);
  * ``ops/warp.grid_sample``'s plain samples, border and zeros padding,
    both ``align_corners``, one to four channels (the kernels compile C =
    1 and 3 in and loop over any other C), with samples outside the
    image: the output and both cotangents (image and grid) against
    ``jax.vjp`` of the JAX ``grid_sample`` (its XLA formulation), to 1e-6
    and 1e-5 of the largest value;
  * ``ops/warp_kernel.warp_sample``, whose CPU path is the kernels' plain
    versions, against ``grid_sample_pallas(image_grad=True)`` in interpret
    mode at tests/test_pallas_warp.py's 16x128 near-identity warp pushed
    past the border (its ``test_pallas_full_grad_matches_xla``): output
    and both cotangents to that test's 1e-6 / 1e-5;
  * the image-gradient wrapper's input checks and the launch counters.
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sfmnext_tpu.ops import geometry as jax_geometry, warp as jax_warp
from sfmnext_tpu.ops.pallas.warp_kernel import grid_sample_pallas
from sfmnext_tpu_torch.ops import geometry, warp, warp_kernel
from test_torch_models import _one_thread  # noqa: F401


def _scaled_close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (err, np.abs(want).max())


def _k3(b, h, w):
    k = np.array([[0.81 * w, 0, 0.51 * w], [0, 1.08 * h, 0.53 * h], [0, 0, 1]], np.float32)
    return np.broadcast_to(k, (b, 3, 3)).copy()


def test_euler_to_mat_and_project_depth_match_jax():
    rng = np.random.RandomState(0)
    angle = (rng.randn(3, 3) * 0.3).astype(np.float32)
    _scaled_close(geometry.euler_to_mat(torch.from_numpy(angle)),
                  jax_geometry.euler_to_mat(angle), 1e-6)
    b, h, w = 2, 12, 20
    points = np.concatenate([rng.randn(b, 3, h * w) * 5 + 10, np.ones((b, 1, h * w))],
                            axis=1).astype(np.float32)
    K = np.broadcast_to(np.eye(4, dtype=np.float32), (b, 4, 4)).copy()
    K[:, :3, :3] = _k3(b, h, w)
    T = np.array(jax_geometry.transformation_from_parameters(
        (rng.randn(b, 3) * 0.05).astype(np.float32), (rng.randn(b, 3) * 0.2).astype(np.float32)))
    got = geometry.project_depth(*(torch.from_numpy(a) for a in (points, K, T)), h, w)
    assert got.shape == (b, h, w, 1)
    _scaled_close(got, jax_geometry.project_depth(points, K, T, h, w), 1e-6)


def test_inverse_rotation_warp_and_its_gradients_match_jax():
    b, h, w = 2, 16, 24
    rng = np.random.RandomState(1)
    img = rng.rand(b, h, w, 3).astype(np.float32)
    rot = np.array([[0.05, -0.03, 0.0], [-0.02, 0.04, 0.0]], np.float32)
    K3 = _k3(b, h, w)
    cot = rng.randn(b, h, w, 3).astype(np.float32)

    def jax_loss(img, rot):
        out = jax_warp.inverse_rotation_warp(img, rot, K3)
        return (out * cot).sum(), out

    (_, expect), expect_grads = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(img, rot)
    args = [torch.from_numpy(a).requires_grad_() for a in (img, rot)]
    got = warp.inverse_rotation_warp(args[0], args[1], torch.from_numpy(K3))
    (got * torch.from_numpy(cot)).sum().backward()
    _scaled_close(got.detach(), expect, 1e-5)
    assert not np.asarray(expect).all()  # the rotation pushes samples out: zeros there
    for a, e in zip(args, expect_grads):
        _scaled_close(a.grad, e, 1e-5)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_plain_samples_and_cotangents_match_jax(padding, align_corners, channels):
    rng = np.random.RandomState(channels + 2 * align_corners)
    img = rng.rand(2, 10, 14, channels).astype(np.float32)
    grid = (rng.rand(2, 7, 9, 2) * 2.4 - 1.2).astype(np.float32)  # some outside
    cot = rng.randn(2, 7, 9, channels).astype(np.float32)
    expect, vjp = jax.vjp(
        lambda i, g: jax_warp.grid_sample(i, g, padding, align_corners), img, grid)
    expect_img, expect_grid = vjp(cot)
    args = [torch.from_numpy(a).requires_grad_() for a in (img, grid)]
    got = warp.grid_sample(*args, padding_mode=padding, align_corners=align_corners)
    got.backward(torch.from_numpy(cot))
    _scaled_close(got.detach(), expect, 1e-6)
    _scaled_close(args[0].grad, expect_img, 1e-5)
    _scaled_close(args[1].grad, expect_grid, 1e-5)


@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_warp_sample_matches_pallas_interpret(padding):
    b, h, w, channels = 1, 16, 128, 1
    rng = np.random.RandomState(6)
    img = rng.rand(b, h, w, channels).astype(np.float32)
    gy, gx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    disp = (rng.rand(b, h, w, 2) - 0.5) * 2 * np.array([2 * 12 / (w - 1), 2 * 3 / (h - 1)])
    grid = ((np.stack([gx, gy], -1)[None] + disp) * 1.08).astype(np.float32)
    cot = rng.randn(b, h, w, channels).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        expect, vjp = jax.vjp(
            lambda i, g: grid_sample_pallas(i, g, True, padding, image_grad=True), img, grid)
        expect_img, expect_grid = vjp(cot)
    args = [torch.from_numpy(a).requires_grad_() for a in (img, grid)]
    got = warp.grid_sample(*args, padding_mode=padding, use_kernel=True)
    got.backward(torch.from_numpy(cot))
    _scaled_close(got.detach(), expect, 1e-6)
    _scaled_close(args[0].grad, expect_img, 1e-6)
    _scaled_close(args[1].grad, expect_grid, 1e-5)
    for fn in (warp_kernel.warp_fwd, warp_kernel.warp_bwd, warp_kernel.warp_bwd_img):
        assert fn.launches == {"border": 0, "zeros": 0}


def test_image_gradient_only_where_the_image_needs_one():
    """A sampled frame that is data gets no cotangent; a sampled tensor
    that carries a gradient gets the plain sample's."""
    img = torch.rand(2, 8, 12, 1)
    fy = torch.rand(2, 8, 12) * 9 - 1
    fx = (torch.rand(2, 8, 12) * 13 - 1).requires_grad_()
    warp_kernel.warp_sample(img, fy, fx, zeros=True).sum().backward()
    assert img.grad is None and fx.grad is not None
    img.requires_grad_()
    warp_kernel.warp_sample(img, fy, fx, zeros=True).sum().backward()
    want = torch.autograd.grad(warp.sample_zeros(img, fy, fx).sum(), img)[0]
    torch.testing.assert_close(img.grad, want, rtol=0, atol=1e-6)


BAD_IMAGE_GRADS = {
    "img_shape_rank": lambda fy, fx, g: (fy, fx, g, (2, 8, 12)),
    "batch": lambda fy, fx, g: (fy, fx, g, (3, 8, 12, 3)),
    "channels": lambda fy, fx, g: (fy, fx, g, (2, 8, 12, 1)),
    "f64_cotangent": lambda fy, fx, g: (fy, fx, g.double(), (2, 8, 12, 3)),
}


@pytest.mark.parametrize("fault", list(BAD_IMAGE_GRADS))
def test_image_gradient_wrapper_rejects_what_the_kernel_does_not_take(fault):
    fy, fx = torch.rand(2, 8, 12) * 7, torch.rand(2, 8, 12) * 11
    g = torch.randn(2, 8, 12, 3)
    with pytest.raises(ValueError):
        warp_kernel.warp_bwd_img(*BAD_IMAGE_GRADS[fault](fy, fx, g))
