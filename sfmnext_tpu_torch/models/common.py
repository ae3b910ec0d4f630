"""Weight initialisation from an explicit ``torch.Generator``, and the
BatchNorm of the JAX package.

Counterpart of the initialisers in ``sfmnext_tpu/models/common.py``: torch's
own defaults, and the JAX package's truncated-normal variance scalings
(flax's ``lecun_normal``, ``kaiming_normal_fanout``), drawn from a
generator so that a model is a function of ``opt.seed`` and leaves the
global RNG alone.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


@torch.no_grad()
def torch_default_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Conv2d/Linear: weight and bias U(-1/sqrt(fan_in), +1/sqrt(fan_in))
    (torch's kaiming_uniform(a=sqrt(5)) default); norms: ones and zeros
    with fresh running statistics."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            nn.init.uniform_(m.weight, -bound, bound, generator=generator)
            if m.bias is not None:
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (momentum 0.1, eps 1e-5) whose running variance
    follows flax's ``nn.BatchNorm`` (``sfmnext_tpu/models/common.py``): in
    training it moves towards the *biased* batch variance, where torch's
    own update uses the unbiased one. Normalisation is unchanged (both use
    the biased variance).

    torch's update of a copy gives new = (1-m) old + m v n/(n-1) for the
    biased variance v over n values a channel; the buffer becomes
    (1-m) old + m v = new (n-1)/n + (1-m) old / n, with no second pass over
    the activations. (The op saves the running variance for its backward,
    so the buffer itself must not change under it.)
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        n = x.numel() // x.shape[1]
        new_var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, new_var, self.weight, self.bias,
                         True, self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.mul_((1 - self.momentum) / n).add_(new_var, alpha=(n - 1) / n)
            self.num_batches_tracked.add_(1)
        return y


@torch.no_grad()
def variance_scaling_(w: torch.Tensor, generator: torch.Generator, scale: float,
                      mode: str) -> None:
    """JAX's ``variance_scaling(scale, mode, "truncated_normal")`` on a
    torch weight: a normal truncated at two deviations, scaled so that its
    variance is scale / fan. The fans are flax's: a convolution's receptive
    field times its input channels a group (``fan_in``) or its outputs
    (``fan_out``); a linear layer's in or out features."""
    receptive = w[0][0].numel() if w.dim() > 2 else 1
    fan = (w.shape[1] if mode == "fan_in" else w.shape[0]) * receptive
    std = math.sqrt(scale / fan) / 0.87962566103423978  # the truncation's std
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default kernel init (``lecun_normal``)."""
    variance_scaling_(w, generator, 1.0, "fan_in")


def kaiming_normal_fanout_(w: torch.Tensor, generator: torch.Generator) -> None:
    """``kaiming_normal_fanout`` of ``sfmnext_tpu/models/common.py``."""
    variance_scaling_(w, generator, 2.0, "fan_out")
