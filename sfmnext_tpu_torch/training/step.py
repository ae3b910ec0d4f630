"""Optimizer and train step. Counterpart of ``sfmnext_tpu/training/step.py``.

Adam(lr, b1 0.9, b2 0.999, eps 1e-8) with the JAX package's step schedule
(one decay by 0.1 after ``scheduler_step_size`` epochs, trainer.py:128-135)
and ``--diff_lr`` (the pose net at a tenth of the rate), and on-device
augmentation (``augment=True``: the flip and the ColorJitter kernel).
Gradient accumulation (``--accumulation_steps``) is not ported yet and
raises.
"""

from __future__ import annotations

import torch

from sfmnext_tpu_torch.data.augment import augment_batch
from sfmnext_tpu_torch.device import disable_tf32
from sfmnext_tpu_torch.training.pipeline import forward


def make_optimizer(opt, models, steps_per_epoch: int):
    """(torch.optim.Adam, its step-LR scheduler) over the bundle's
    parameters; call the scheduler once after every optimizer step."""
    if opt.accumulation_steps > 1:
        raise NotImplementedError("gradient accumulation is not ported yet")
    groups = [
        {"params": list(m.parameters()),
         "lr": opt.learning_rate * (0.1 if opt.diff_lr and name == "pose" else 1.0)}
        for name, m in models.modules().items()
    ]
    adam = torch.optim.Adam(groups, lr=opt.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    boundary = opt.scheduler_step_size * steps_per_epoch
    scheduler = torch.optim.lr_scheduler.MultiStepLR(adam, milestones=[boundary], gamma=0.1)
    return adam, scheduler


def make_train_step(opt, models, optimizer, scheduler, augment: bool = False):
    """The train step: ``step(batch, generator=None) -> metrics``.

    With ``augment=True`` it first flips and colour-jitters the batch on
    its device (``data/augment.augment_batch``, no flip for ``nyu_raw``),
    drawing from the generator, which is then required. With a
    ``torch.Generator`` on the batch's device it draws the identity-loss
    tie-break noise (1e-5 * N(0,1), [1,H,W,n_sources]); without one it adds
    none. Then it runs forward and backward, updates the parameters (and,
    in the forward, the BatchNorm running statistics), and steps the
    schedule. Metrics stay on the device (no sync): the losses, and the
    full-resolution depth under ``"depth"``. Turns TF32 off, so float32
    products stay float32.
    """
    disable_tf32()
    n_sources = len(opt.all_frame_ids) - 1
    allow_flip = opt.dataset != "nyu_raw"  # indoor NYU trains without flips

    def train_step(batch, generator=None):
        if augment:
            if generator is None:
                raise ValueError("augment=True draws the flip and the jitter from a "
                                 "torch.Generator; pass one")
            batch = augment_batch(batch, generator, allow_flip)
        noise = None
        if generator is not None:
            _, _, h, w, _ = batch["color"].shape
            noise = 1e-5 * torch.randn((1, h, w, n_sources), generator=generator,
                                       device=batch["color"].device)
        optimizer.zero_grad(set_to_none=True)
        total, aux = forward(models, batch, opt, noise)
        total.backward()
        optimizer.step()
        scheduler.step()
        metrics = {k: v.detach() for k, v in aux["metrics"].items()}
        metrics["depth"] = aux["outputs"]["depth"].detach()
        return metrics

    return train_step
