"""Checkpoints in the reference's own layout (reference trainer.py:638-688).

One folder per ``weights_<tag>`` holds a state dict a module:
``encoder.pth`` (with ``height``, ``width`` and ``use_stereo`` for shape
recovery at inference, :652-656), ``depth.pth``, ``pose.pth`` and, when the
bundle has them, ``pose_encoder.pth``, ``rectify.pth`` and
``predictive_mask.pth``; ``utils/jax_weights.load_reference_folder``
and ``test_simple`` read the first two. ``adam.pth`` holds what a resumed
run needs to continue exactly: the optimizer (Adam's moments and step), the
LR schedule, the step count, and the gradient accumulation's place in its
cycle with the running mean of the cycle's gradients so far (where
``optax.MultiSteps`` keeps them inside its state).

A folder is written beside its final name and renamed into place, so a
run stopped while writing leaves no half-written ``weights_*`` folder.
"""

from __future__ import annotations

import os
import shutil
from typing import Iterable

import torch

NON_TENSOR_KEYS = ("height", "width", "use_stereo")


def save_checkpoint(folder: str, models, opt, optimizer, scheduler, accumulation,
                    step: int) -> None:
    """Write the bundle's modules and the training state into ``folder``
    (``accumulation`` None: a run without gradient accumulation)."""
    parent, name = os.path.split(os.path.abspath(folder))
    tmp = os.path.join(parent, f".{name}.partial")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    for module_name, module in models.modules().items():
        sd = dict(module.state_dict())
        if module_name == "encoder":
            sd.update(height=opt.height, width=opt.width, use_stereo=opt.use_stereo)
        torch.save(sd, os.path.join(tmp, f"{module_name}.pth"))
    torch.save({
        "optimizer": optimizer.state_dict(),
        "scheduler": scheduler.state_dict(),
        "step": int(step),
        "accumulation": None if accumulation is None else accumulation.state_dict(),
    }, os.path.join(tmp, "adam.pth"))
    shutil.rmtree(folder, ignore_errors=True)
    os.replace(tmp, folder)


def load_module(folder: str, name: str, module) -> None:
    """``<folder>/<name>.pth`` into ``module``, strictly (the reference's
    ``module.`` prefix of a DataParallel save stripped)."""
    sd = torch.load(os.path.join(folder, f"{name}.pth"), map_location="cpu", weights_only=True)
    sd = {k.removeprefix("module."): v for k, v in sd.items() if k not in NON_TENSOR_KEYS}
    module.load_state_dict(sd, strict=True)


def load_encoder_depth(folder: str, models) -> None:
    """A reference-layout folder's ``encoder.pth`` and, if present,
    ``depth.pth`` into the bundle (reference evaluate_depth_config.py:92-117,
    trainer.py:66-90). A folder without ``encoder.pth`` (an orbax checkpoint
    of the JAX package) raises."""
    if not os.path.exists(os.path.join(folder, "encoder.pth")):
        raise FileNotFoundError(
            f"{folder} holds no encoder.pth: the port reads reference-layout .pth folders; "
            "convert an orbax checkpoint with the JAX package's tools/ckpt_to_pth.py first")
    load_module(folder, "encoder", models.encoder)
    if os.path.exists(os.path.join(folder, "depth.pth")):
        load_module(folder, "depth", models.depth)


def load_modules(folder: str, models, names: Iterable[str]) -> None:
    """The named modules of the bundle from ``folder``."""
    bundle = models.modules()
    for name in names:
        load_module(folder, name, bundle[name])


def load_training_state(folder: str, optimizer, scheduler, accumulation):
    """Restore ``adam.pth`` into the optimizer, the schedule and the
    accumulation; returns the saved step count, or None when the folder
    has no ``adam.pth``."""
    path = os.path.join(folder, "adam.pth")
    if not os.path.exists(path):
        return None
    state = torch.load(path, map_location="cpu", weights_only=True)
    optimizer.load_state_dict(state["optimizer"])
    scheduler.load_state_dict(state["scheduler"])
    accumulation.load_state_dict(state["accumulation"])
    return int(state["step"])
