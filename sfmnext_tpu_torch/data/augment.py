"""On-device augmentation: horizontal flip and torchvision-style ColorJitter.
Counterpart of ``sfmnext_tpu/data/augment.py``.

Behavioral reference: datasets/mono_dataset.py:140-141 (50% colour jitter,
50% flip per item), :177-180 (ColorJitter with brightness, contrast and
saturation factors in 0.8-1.2 and a hue shift in +-0.1, applied in a random
order, the same for every frame of an item).
The flip applies to ``color`` and ``color_aug`` (and to ``depth_gt`` when
present); the jitter to ``color_aug`` only, which is made from the flipped
``color``. Stereo batches are not ported (the JAX package also negates the
flipped baseline, mono_dataset.py:195-197).

The draws come from a ``torch.Generator`` (``jitter_params``,
``augment_batch``); ``apply_augmentation`` takes them explicitly, so a test
can hand in the JAX package's draws. The jitter is
``ops/jitter_kernel.color_jitter``: the Hopper kernel on a CUDA batch, its
plain version (``plain_color_jitter``, the per-op functions) on a CPU one.
"""

from __future__ import annotations

import torch

from sfmnext_tpu_torch.ops.jitter_kernel import color_jitter


def jitter_params(generator: torch.Generator, b: int):
    """Per-sample draws of ColorJitter: (order [B,4] int32, a random
    permutation of the ops; factors [B,4] float32 (brightness, contrast,
    saturation in U(0.8, 1.2), hue in U(-0.1, 0.1)); do_jit [B] bool, each
    with probability 0.5), on the generator's device."""
    dev = generator.device
    order = torch.argsort(torch.rand(b, 4, generator=generator, device=dev), dim=1)
    u = torch.rand(b, 4, generator=generator, device=dev)
    factors = torch.cat([0.8 + 0.4 * u[:, :3], -0.1 + 0.2 * u[:, 3:]], dim=1)
    do_jit = torch.rand(b, generator=generator, device=dev) < 0.5
    return order.to(torch.int32), factors, do_jit


def apply_augmentation(batch, do_flip, do_jit, order, factors):
    """The flip and the jitter with the draws given (do_flip, do_jit [B]
    bool; order, factors as ``jitter_params``); returns a new batch dict."""
    color = batch["color"]
    flip5 = do_flip.reshape(-1, 1, 1, 1, 1)
    flipped = torch.where(flip5, color.flip(3), color)
    out = dict(batch)
    out["color"] = flipped
    out["color_aug"] = color_jitter(flipped, order, factors, do_jit)
    if "depth_gt" in batch:
        out["depth_gt"] = torch.where(flip5[:, 0], batch["depth_gt"].flip(2), batch["depth_gt"])
    return out


def augment_batch(batch, generator: torch.Generator, allow_flip: bool = True):
    """Flip each sample with probability 0.5 (0 without ``allow_flip``) and
    jitter it with probability 0.5, drawing from ``generator``."""
    b = batch["color"].shape[0]
    dev = generator.device
    do_flip = torch.rand(b, generator=generator, device=dev) < (0.5 if allow_flip else 0.0)
    order, factors, do_jit = jitter_params(generator, b)
    return apply_augmentation(batch, do_flip, do_jit, order, factors)
