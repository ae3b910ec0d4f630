"""The port's on-device augmentation against the JAX package's, on the CPU.

  * ``data/augment.apply_augmentation`` fed the JAX package's draws (the
    key tree of ``augment_batch``, sfmnext_tpu/data/augment.py:162-166,
    and ``jax.vmap(jitter_params)``) against JAX ``augment_batch`` with
    ``use_pallas=False``: flipped ``color`` and ``depth_gt`` exactly, the
    jittered ``color_aug`` to 2e-6 (the same float32 formulas; the
    contrast mean sums in another order);
  * ``ops/jitter_kernel.color_jitter``, whose CPU path is the plain
    ``plain_color_jitter``, against ``color_jitter_pallas`` in interpret mode for
    op orders with contrast first, in the middle and last, to 2e-6, the
    tolerance tests/test_jitter_kernel.py holds the Pallas kernel to;
  * a sample with ``do_jit`` false is copied bit for bit, and the flip
    applies to ``color`` and ``color_aug``;
  * a flipped stereo sample's baseline ``stereo_T[0, 3]`` changes sign,
    exactly as JAX ``augment_batch`` flips it;
  * the wrapper's input checks, its launch counter staying 0, and draws
    from a ``torch.Generator`` in their ranges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sfmnext_tpu.data import augment as jax_augment
from sfmnext_tpu.ops.pallas import jitter_kernel as jax_jitter_kernel
from sfmnext_tpu_torch.data import augment
from sfmnext_tpu_torch.ops import jitter_kernel
from test_torch_models import _one_thread  # noqa: F401


B, F, H, W = 4, 2, 16, 24


def _color(seed, b=B, h=H, w=W):
    return np.random.RandomState(seed).rand(b, F, h, w, 3).astype(np.float32)


def test_augmentation_matches_jax_with_its_draws():
    batch = {"color": _color(0),
             "depth_gt": np.random.RandomState(1).rand(B, H, W, 1).astype(np.float32)}
    key = jax.random.PRNGKey(2)
    expect = jax_augment.augment_batch(batch, key, use_pallas=False)
    k_flip, k_dojit, k_jit = jax.random.split(key, 3)  # augment.py:162-166
    do_flip = np.array(jax.random.bernoulli(k_flip, 0.5, (B,)))
    do_jit = np.array(jax.random.bernoulli(k_dojit, 0.5, (B,)))
    order, factors = jax.vmap(jax_augment.jitter_params)(jax.random.split(k_jit, B))
    assert do_flip.any() and not do_flip.all() and do_jit.any() and not do_jit.all()

    got = augment.apply_augmentation(
        {k: torch.from_numpy(v) for k, v in batch.items()}, torch.from_numpy(do_flip),
        torch.from_numpy(do_jit), torch.from_numpy(np.array(order, np.int32)),
        torch.from_numpy(np.array(factors)))
    np.testing.assert_array_equal(got["color"].numpy(), np.asarray(expect["color"]))
    np.testing.assert_array_equal(got["depth_gt"].numpy(), np.asarray(expect["depth_gt"]))
    np.testing.assert_allclose(got["color_aug"].numpy(), np.asarray(expect["color_aug"]),
                               rtol=0, atol=2e-6)


def test_stereo_flip_negates_the_baseline_as_jax():
    """A stereo batch (``stereo_T`` with baseline 0.1, mono_dataset.py:
    195-197): the flipped samples' baseline changes sign, exactly as the
    JAX ``augment_batch`` with the same key; the rest of the transform
    and the unflipped samples stay as they were."""
    stereo_T = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    stereo_T[:, 0, 3] = 0.1
    stereo_T[:, 1, 3] = 0.02
    batch = {"color": _color(0), "stereo_T": stereo_T}
    key = jax.random.PRNGKey(2)
    expect = jax_augment.augment_batch({k: jnp.asarray(v) for k, v in batch.items()}, key,
                                       use_pallas=False)
    k_flip, k_dojit, k_jit = jax.random.split(key, 3)  # augment.py:162-166
    do_flip = np.array(jax.random.bernoulli(k_flip, 0.5, (B,)))
    do_jit = np.array(jax.random.bernoulli(k_dojit, 0.5, (B,)))
    order, factors = jax.vmap(jax_augment.jitter_params)(jax.random.split(k_jit, B))
    assert do_flip.any() and not do_flip.all()

    got = augment.apply_augmentation(
        {k: torch.from_numpy(v) for k, v in batch.items()}, torch.from_numpy(do_flip),
        torch.from_numpy(do_jit), torch.from_numpy(np.array(order, np.int32)),
        torch.from_numpy(np.array(factors)))
    np.testing.assert_array_equal(got["stereo_T"].numpy(), np.asarray(expect["stereo_T"]))
    np.testing.assert_array_equal(got["stereo_T"][:, 0, 3].numpy(),
                                  np.where(do_flip, -0.1, 0.1).astype(np.float32))
    np.testing.assert_array_equal(batch["stereo_T"][:, 0, 3], np.float32(0.1))  # untouched


def test_jitter_matches_pallas_interpret():
    color = _color(3, b=4, h=32, w=128)
    order = np.array([[1, 0, 2, 3], [3, 2, 0, 1], [2, 1, 3, 0], [0, 3, 1, 2]], np.int32)
    factors = np.array([[1.15, 0.85, 1.2, -0.07], [0.83, 1.18, 0.9, 0.09],
                        [1.05, 0.81, 0.84, 0.03], [0.95, 1.1, 1.19, -0.1]], np.float32)
    do_jit = np.array([True, True, True, False])
    with pltpu.force_tpu_interpret_mode():
        expect = jax_jitter_kernel.color_jitter_pallas(
            jnp.asarray(color), jnp.asarray(order), jnp.asarray(factors), jnp.asarray(do_jit))
    got = jitter_kernel.color_jitter(
        *(torch.from_numpy(a) for a in (color, order, factors, do_jit)))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=0, atol=2e-6)
    np.testing.assert_array_equal(got[3].numpy(), color[3])


def test_no_jitter_copies_and_the_flip_reaches_both_colours():
    color = torch.from_numpy(_color(4))
    order, factors, _ = augment.jitter_params(torch.Generator().manual_seed(0), B)
    do_flip = torch.tensor([True, False, True, False])
    out = augment.apply_augmentation({"color": color}, do_flip, torch.zeros(B, dtype=torch.bool),
                                     order, factors)
    expect = torch.where(do_flip[:, None, None, None, None], color.flip(3), color)
    assert torch.equal(out["color"], expect)
    assert torch.equal(out["color_aug"], expect)
    assert torch.equal(out["color"][0, :, :, 0], color[0, :, :, -1])


def test_draws_from_a_generator():
    order, factors, do_jit = augment.jitter_params(torch.Generator().manual_seed(1), 64)
    assert order.dtype == torch.int32 and factors.dtype == torch.float32
    assert torch.equal(order.sort(dim=1).values, torch.arange(4, dtype=torch.int32).expand(64, 4))
    lo, hi = torch.tensor([0.8, 0.8, 0.8, -0.1]), torch.tensor([1.2, 1.2, 1.2, 0.1])
    assert bool(((factors >= lo) & (factors <= hi)).all())
    assert 0 < int(do_jit.sum()) < 64
    batch = {"color": torch.from_numpy(_color(5))}
    a = augment.augment_batch(batch, torch.Generator().manual_seed(2))
    b = augment.augment_batch(batch, torch.Generator().manual_seed(2))
    assert torch.equal(a["color_aug"], b["color_aug"])
    no_flip = augment.augment_batch(batch, torch.Generator().manual_seed(2), allow_flip=False)
    assert torch.equal(no_flip["color"], batch["color"])


BAD_INPUTS = {
    "f64_color": lambda c, o, f, d: (c.double(), o, f, d),
    "nchw_color": lambda c, o, f, d: (c.permute(0, 1, 4, 2, 3).contiguous(), o, f, d),
    "strided_color": lambda c, o, f, d: (c.transpose(2, 3).contiguous().transpose(2, 3), o, f, d),
    "int64_order": lambda c, o, f, d: (c, o.long(), f, d),
    "float_do_jit": lambda c, o, f, d: (c, o, f, d.float()),
}


@pytest.mark.parametrize("fault", list(BAD_INPUTS))
def test_jitter_wrapper_rejects_what_the_kernel_does_not_take(fault):
    args = (torch.from_numpy(_color(6)), *augment.jitter_params(torch.Generator(), B))
    with pytest.raises(ValueError):
        jitter_kernel.color_jitter(*BAD_INPUTS[fault](*args))


def test_cpu_jitter_launches_no_kernel():
    augment.augment_batch({"color": torch.from_numpy(_color(7))}, torch.Generator())
    assert jitter_kernel.color_jitter.launches == 0
