"""Optimizer and train step. Counterpart of ``sfmnext_tpu/training/step.py``.

Adam(lr, b1 0.9, b2 0.999, eps 1e-8) with the JAX package's step schedule
(one decay by 0.1 after ``scheduler_step_size`` epochs, trainer.py:128-135),
``--diff_lr`` (the pose and rectify nets at a tenth of the rate),
gradient accumulation over ``--accumulation_steps`` micro-steps with
``optax.MultiSteps`` semantics (trainer_indoor.py:295-307), the outdoor or
indoor pipeline (``select_pipeline``), on-device augmentation
(``augment=True``: the flip and the ColorJitter kernel), and the
forward-only eval step and depth inference of the same modules.
"""

from __future__ import annotations

import contextlib

import torch

from sfmnext_tpu_torch.data.augment import augment_batch
from sfmnext_tpu_torch.device import disable_tf32
from sfmnext_tpu_torch.ops.image import resize_bilinear
from sfmnext_tpu_torch.training.pipeline import autocast, forward


def make_optimizer(opt, models, steps_per_epoch: int):
    """(torch.optim.Adam, its step-LR scheduler) over the bundle's
    parameters; call the scheduler once after every optimizer step (with
    accumulation: every ``accumulation_steps`` micro-steps, as
    ``optax.MultiSteps`` advances its inner schedule)."""
    groups = [
        {"params": list(m.parameters()),
         "lr": opt.learning_rate * (0.1 if opt.diff_lr and name in ("pose", "rectify") else 1.0)}
        for name, m in models.modules().items()
    ]
    adam = torch.optim.Adam(groups, lr=opt.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    boundary = opt.scheduler_step_size * steps_per_epoch
    scheduler = torch.optim.lr_scheduler.MultiStepLR(adam, milestones=[boundary], gamma=0.1)
    return adam, scheduler


class Accumulation:
    """``optax.MultiSteps(every_k_schedule=every)`` over a torch optimizer:
    the gradients of ``every`` micro-steps are averaged as optax does, by a
    running mean from zeros (acc += (g - acc) / (n + 1) after micro-step
    n), and only then do Adam and the schedule take a step; the parameters
    do not move before it. ``every=1`` is a plain step. A parameter that a
    micro-step leaves without a gradient gets zeros there, as JAX's
    gradient of a parameter the loss does not reach; so Adam still decays
    its moments and moves it, as optax's Adam does."""

    def __init__(self, optimizer, scheduler, every: int = 1):
        if every < 1:
            raise ValueError(f"accumulation_steps must be >= 1, got {every}")
        self.optimizer, self.scheduler, self.every = optimizer, scheduler, every
        self.params = [p for group in optimizer.param_groups for p in group["params"]]
        self.micro_step = 0
        self._acc = None

    def zero_grad(self) -> None:
        """Before a micro-step's backward: the gradients start from None,
        the running mean of the cycle's earlier micro-steps set aside."""
        if self.micro_step > 0:
            self._acc = [p.grad for p in self.params]
        for p in self.params:
            p.grad = None

    def step(self) -> bool:
        """After a micro-step's backward; True when the parameters moved."""
        with torch.no_grad():
            for i, p in enumerate(self.params):
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                if self._acc is not None:
                    acc = self._acc[i]
                    p.grad = acc + (p.grad - acc) / (self.micro_step + 1)
        self._acc = None
        self.micro_step += 1
        if self.micro_step < self.every:
            return False
        self.micro_step = 0
        self.optimizer.step()
        self.scheduler.step()
        return True

    def state_dict(self):
        """The place in the cycle and, mid-cycle, the running mean of the
        cycle's gradients (it waits in ``p.grad`` between micro-steps)."""
        mean = [p.grad for p in self.params] if self.micro_step else None
        return {"micro_step": self.micro_step, "mean": mean}

    def load_state_dict(self, state) -> None:
        self.micro_step = state["micro_step"]
        mean = state["mean"]
        for i, p in enumerate(self.params):
            p.grad = None if mean is None else mean[i].to(p.device)


def select_pipeline(opt):
    """The outdoor (trainer.py) or indoor (trainer_indoor.py) forward, as
    the JAX package picks it (step.py:85-99)."""
    if (opt.use_rectify_net or opt.use_photo_geo_loss or opt.use_improved_mini_reproj_loss
            or opt.dataset in ("nyu_raw", "mc_dataset", "mc_mini_dataset")):
        from sfmnext_tpu_torch.training.indoor import forward_indoor

        return forward_indoor
    return forward


def make_train_step(opt, models, optimizer, scheduler, augment: bool = False):
    """The train step: ``step(batch, generator=None) -> metrics``.

    With ``augment=True`` it first flips and colour-jitters the batch on
    its device (``data/augment.augment_batch``, no flip for ``nyu_raw``),
    drawing from the generator, which is then required. A
    ``torch.Generator`` on the batch's device also draws the identity-loss
    tie-break noise (1e-5 * N(0,1), in each loss route's shape); without
    one the step adds none. Then it runs the forward of ``select_pipeline``
    and the backward, and, on every ``opt.accumulation_steps``-th call,
    averages the accumulated gradients, updates the parameters and steps
    the schedule (the BatchNorm running statistics update in every
    forward). Metrics stay on the device (no sync): the losses, and the
    full-resolution depth under ``"depth"``. The step's ``Accumulation``
    is its ``accumulation`` attribute (a checkpoint saves its state).
    Turns TF32 off, so float32 products stay float32.
    """
    disable_tf32()
    forward_fn = select_pipeline(opt)
    allow_flip = opt.dataset != "nyu_raw"  # indoor NYU trains without flips
    accumulation = Accumulation(optimizer, scheduler, opt.accumulation_steps)

    def train_step(batch, generator=None):
        if augment:
            if generator is None:
                raise ValueError("augment=True draws the flip and the jitter from a "
                                 "torch.Generator; pass one")
            batch = augment_batch(batch, generator, allow_flip)
        accumulation.zero_grad()
        total, aux = forward_fn(models, batch, opt, generator)
        total.backward()
        accumulation.step()
        metrics = {k: v.detach() for k, v in aux["metrics"].items()}
        metrics["depth"] = aux["outputs"]["depth"].detach()
        return metrics

    train_step.accumulation = accumulation
    return train_step


@contextlib.contextmanager
def eval_mode(models):
    """The bundle's modules in eval mode (BatchNorm on its running
    statistics, which it leaves alone; dropout off) and without autograd;
    every submodule's own mode is restored on the way out."""
    modes = [(m, m.training) for mod in models.modules().values() for m in mod.modules()]
    try:
        for mod in models.modules().values():
            mod.eval()
        with torch.no_grad():
            yield
    finally:
        for m, training in modes:
            m.training = training


def make_eval_step(opt, models):
    """The forward-only step: ``eval_step(batch) -> (metrics, outputs)``.

    Runs ``select_pipeline(opt)``'s forward on the train step's own modules
    in ``eval_mode`` with no generator (no tie-break noise), as the JAX
    package's eval step runs the eval-mode models on the shared parameters
    with no rng. A batch without ``color_aug`` uses ``color``. Turns TF32
    off.
    """
    disable_tf32()
    forward_fn = select_pipeline(opt)

    def eval_step(batch):
        if "color_aug" not in batch:
            batch = {**batch, "color_aug": batch["color"]}
        with eval_mode(models):
            _, aux = forward_fn(models, batch, opt, None)
        return aux["metrics"], aux["outputs"]

    return eval_step


def make_infer_fn(opt, models):
    """Depth inference on the bundle's modules in ``eval_mode``:
    ``infer(images [B,H,W,3]) -> depth [B,H,W,1]`` float32, the decoder's
    half-resolution depth resized to the input's size. Turns TF32 off."""
    disable_tf32()

    def infer(images):
        h, w = images.shape[1:3]
        with eval_mode(models):
            with autocast(models, images.device):
                out = models.depth(models.encoder(images.permute(0, 3, 1, 2)))
            return resize_bilinear(out["disp0"], (h, w), align_corners=False).permute(0, 2, 3, 1)

    return infer
