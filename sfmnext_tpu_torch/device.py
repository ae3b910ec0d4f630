"""The card the port's entry points run on."""

from __future__ import annotations

import torch


def cuda_device(index: int = 0) -> torch.device:
    """The CUDA card ``index``; raises when there is none (never the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this entry point runs on the card")
    return torch.device("cuda", index)


def opt_device(opt) -> torch.device:
    """The device an entry point runs on: the CPU with ``--no_cuda``,
    else the CUDA card (``cuda_device``: no fallback to the CPU)."""
    return torch.device("cpu") if opt.no_cuda else cuda_device()


def disable_tf32() -> None:
    """Run float32 matmuls and convolutions in full float32.

    cuDNN convolutions default to TF32 on Hopper (about three decimal
    digits); the JAX reference computes float32 in float32. Entry points
    call this explicitly; importing the package changes nothing.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
