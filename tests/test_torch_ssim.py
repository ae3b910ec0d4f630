"""The port's SSIM loss against the JAX package's, on the CPU.

  * ``ops/image.py`` (``box_filter_reflect``, ``ssim``, ``ssim_multi``) and
    ``ops/losses.py`` (``reprojection_loss``, ``reprojection_losses_stacked``
    with SSIM on and off) against ``sfmnext_tpu.ops.image`` and
    ``sfmnext_tpu.ops.losses`` in float32 at [2,16,40,3]: the same
    arithmetic (a reflect pad and an average pool against band matmuls),
    to 1e-5;
  * ``ops/ssim_kernel.py``'s entry points, whose CPU path is the kernels'
    plain versions, against the Pallas kernels in interpret mode at
    tests/test_ssim_kernel.py's shape (B=2, 16x128, 2 sources) with the
    tolerances that file holds the Pallas kernels to the XLA path with:
    the maps and the min to 2e-2, the gradients to 5e-2 of their largest
    value (the Pallas kernels round p*p and the first box pass to bf16,
    the plain versions do not). The automasks agree wherever the winning
    margin exceeds twice the largest gap between the two sides' maps
    (4e-3 here), and the gradients wherever no winner within a window's
    reach is that close;
  * an exact tie of an identity and a warped source goes to the identity:
    automask 0 and no gradient;
  * the wrappers' input checks, and their launch counters staying 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sfmnext_tpu.ops import image as jax_image, losses as jax_losses
from sfmnext_tpu.ops.pallas import ssim_kernel as jax_ssim_kernel
from sfmnext_tpu_torch.ops import image, losses, ssim_kernel

FWD_TOL = 2e-2
GRAD_TOL = 5e-2


def _images(seed, n, shape):
    rng = np.random.RandomState(seed)
    return [rng.rand(*shape).astype(np.float32) for _ in range(n)]


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, expect, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(expect), rtol=0, atol=atol)


PLAIN_OPS = {
    "box_filter_reflect": (lambda m, x, y: m.box_filter_reflect(x, 7), "image"),
    "ssim": (lambda m, x, y: m.ssim(x, y), "image"),
    "ssim_multi": (lambda m, x, y: m.ssim_multi(
        jnp.concatenate([x, y], -1) if m is jax_image else torch.cat([x, y], -1),
        m.ssim_target_stats(y)), "image"),
    "reprojection_loss": (lambda m, x, y: m.reprojection_loss(x, y), "losses"),
    "stacked_ssim": (lambda m, x, y: m.reprojection_losses_stacked([x, y], y), "losses"),
    "stacked_l1": (lambda m, x, y: m.reprojection_losses_stacked([x, y], y, use_ssim=False),
                   "losses"),
}


@pytest.mark.parametrize("name", list(PLAIN_OPS))
def test_plain_ssim_ops_match_jax(name):
    fn, where = PLAIN_OPS[name]
    x, y = _images(0, 2, (2, 16, 40, 3))
    jax_mod, mod = (jax_image, image) if where == "image" else (jax_losses, losses)
    expect = fn(jax_mod, jnp.asarray(x), jnp.asarray(y))
    got = fn(mod, *_t([x, y]))
    assert got.dtype == torch.float32 and tuple(got.shape) == expect.shape
    _close(got, expect, 1e-5)


B, H, W = 2, 16, 128


def test_reprojection_losses_match_pallas():
    *preds, target = _images(1, 3, (B, H, W, 3))

    def loss(fn, *ps):
        return (fn(list(ps), target) ** 2).mean()

    with pltpu.force_tpu_interpret_mode():
        expect = jax_ssim_kernel.reprojection_losses_pallas(preds, target)
        expect_grads = jax.grad(
            lambda *ps: loss(jax_ssim_kernel.reprojection_losses_pallas, *ps),
            argnums=(0, 1))(*preds)
    ps = [p.requires_grad_() for p in _t(preds)]
    got = ssim_kernel.reprojection_losses(ps, torch.from_numpy(target))
    (got ** 2).mean().backward()
    _close(got.detach(), expect, FWD_TOL)
    for p, e in zip(ps, expect_grads):
        scale = float(np.abs(np.asarray(e)).max())
        _close(p.grad / scale, np.asarray(e) / scale, GRAD_TOL)


def _near_ties(margin_ok, r=3):
    """Pixels with no ambiguous winner within r pixels (a 7x7 window)."""
    bad = torch.from_numpy(~margin_ok).float()[:, None]
    return ~(torch.nn.functional.max_pool2d(bad, 2 * r + 1, 1, r)[:, 0] > 0).numpy()


def test_reprojection_min_matches_pallas():
    *preds, target = _images(2, 3, (B, H, W, 3))
    idents = _images(3, 2, (B, H, W, 3))
    # large noise separates the winners, as tests/test_ssim_kernel.py does
    noise = (np.random.RandomState(4).randn(1, H, W, 2) * 0.3).astype(np.float32)

    def loss(a, b):
        to_opt, _ = jax_ssim_kernel.reprojection_min_pallas([a, b], idents, target, noise)
        return (to_opt ** 2).mean()

    with pltpu.force_tpu_interpret_mode():
        expect, expect_mask = jax_ssim_kernel.reprojection_min_pallas(
            preds, idents, target, noise)
        expect_grads = jax.grad(loss, argnums=(0, 1))(*preds)
    ps = [p.requires_grad_() for p in _t(preds)]
    got, mask = ssim_kernel.reprojection_min(ps, _t(idents), torch.from_numpy(target),
                                             torch.from_numpy(noise))
    (got ** 2).mean().backward()
    _close(got.detach(), expect, FWD_TOL)

    # Where the port's winner leads by more than twice the largest gap
    # between the two sides' maps, the Pallas kernels pick it too
    t = torch.from_numpy(target)
    with pltpu.force_tpu_interpret_mode():
        pallas_maps = np.concatenate([
            jax_ssim_kernel.reprojection_losses_pallas(idents, target, need_grad=False),
            jax_ssim_kernel.reprojection_losses_pallas(preds, target)], axis=-1)
    maps = torch.cat([ssim_kernel.plain_maps(_t(idents), t),
                      ssim_kernel.plain_maps([p.detach() for p in ps], t)], dim=-1)
    gap = float(np.abs(maps.numpy() - pallas_maps).max())
    assert gap < FWD_TOL
    maps[..., :2] += torch.from_numpy(noise)
    top2 = maps.topk(2, dim=-1, largest=False).values
    clear = (top2[..., 1] - top2[..., 0]).numpy() > 2 * gap
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(mask.numpy()[clear], np.asarray(expect_mask)[clear])
    settled = _near_ties(clear)
    assert settled.mean() > 0.05
    for p, e in zip(ps, expect_grads):
        e = np.asarray(e)
        scale = float(np.abs(e).max())
        _close(p.grad.numpy()[settled] / scale, e[settled] / scale, GRAD_TOL)


@pytest.mark.parametrize("loss_dtype", [torch.float32, torch.bfloat16], ids=str)
def test_identity_takes_a_tie(loss_dtype):
    """A warped source equal to an identity source loses to it."""
    pred, other, target = _t(_images(5, 3, (1, 8, 12, 3)))
    preds = [pred.clone().requires_grad_(), (other + 0.5).clone().requires_grad_()]
    to_opt, mask = ssim_kernel.reprojection_min(preds, [pred, other + 0.5], target,
                                                None, loss_dtype=loss_dtype)
    to_opt.sum().backward()
    assert not mask.any()
    assert not preds[0].grad.any() and not preds[1].grad.any()


def test_plain_min_is_the_first_minimum_in_concat_order():
    """arg: N + m for identity m, k for warped source k; the first minimum
    of [ident..., reproj...] wins."""
    b, h, w = 1, 6, 9
    idents = [torch.rand(b, h, w, 3) for _ in range(2)]
    t = torch.rand(b, h, w, 3)
    maps = ssim_kernel.plain_maps(idents, t)
    reproj = torch.rand(b, h, w, 3)
    reproj[0, 0, 0] = 2.0
    reproj[0, 0, 0, 0] = maps[0, 0, 0].min()  # the best identity and warped source 0 tie
    reproj[0, 0, 1, 1] = reproj[0, 0, 1, 2] = -1.0  # two warped sources tie
    got_min, got_arg = ssim_kernel.ssim_ident_min(idents, t, None, reproj)
    combined = torch.cat([maps, reproj], dim=-1)
    np.testing.assert_array_equal(got_min.numpy(), combined.amin(dim=-1).numpy())
    order = torch.tensor([3, 4, 0, 1, 2], dtype=torch.int32)  # concat index -> arg
    np.testing.assert_array_equal(got_arg.numpy(), order[combined.argmin(dim=-1)].numpy())
    assert int(got_arg[0, 0, 0]) == 3 + int(maps[0, 0, 0].argmin())
    assert int(got_arg[0, 0, 1]) == 1


def _good():
    preds = [torch.rand(2, 8, 12, 3) for _ in range(2)]
    return preds, torch.rand(2, 8, 12, 3)


BAD_INPUTS = {
    "f64_target": lambda p, t: (p, t.double()),
    "strided_source": lambda p, t: ([p[0].transpose(1, 2).contiguous().transpose(1, 2), p[1]], t),
    "source_shape": lambda p, t: ([p[0][:, :-1].contiguous(), p[1]], t),
    "two_channels": lambda p, t: ([x[..., :2].contiguous() for x in p], t[..., :2].contiguous()),
    "three_rows": lambda p, t: ([x[:, :3].contiguous() for x in p], t[:, :3].contiguous()),
    "nine_sources": lambda p, t: ((p * 5)[:9], t),
}


@pytest.mark.parametrize("fault", list(BAD_INPUTS))
def test_ssim_wrappers_reject_what_the_kernels_do_not_take(fault):
    preds, target = BAD_INPUTS[fault](*_good())
    with pytest.raises(ValueError):
        ssim_kernel.ssim_fwd(preds, target)


def test_ssim_wrappers_check_cotangents_and_noise():
    preds, target = _good()
    maps = ssim_kernel.ssim_fwd(preds, target)
    with pytest.raises(ValueError):  # noise for three identities, not two
        ssim_kernel.ssim_ident_min(preds, target, torch.zeros(1, 8, 12, 3), maps)
    with pytest.raises(ValueError):  # a routed cotangent needs an int32 argument
        ssim_kernel.ssim_bwd(preds, target, torch.ones(2, 8, 12), torch.zeros(2, 8, 12))
    with pytest.raises(ValueError):  # bf16 or float32 only
        ssim_kernel.ssim_fwd(preds, target, loss_dtype=torch.float16)


def test_cpu_ssim_launches_no_kernel():
    preds, target = _good()
    preds = [p.requires_grad_() for p in preds]
    to_opt, _ = ssim_kernel.reprojection_min(preds, [p.detach() for p in preds], target)
    (to_opt.sum() + ssim_kernel.reprojection_losses(preds, target).sum()).backward()
    assert (ssim_kernel.ssim_fwd.launches, ssim_kernel.ssim_ident_min.launches,
            ssim_kernel.ssim_bwd.launches) == (0, 0, 0)
