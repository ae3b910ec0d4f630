"""Weight initialisation from an explicit ``torch.Generator``.

Counterpart of the initialisers in ``sfmnext_tpu/models/common.py``: torch's
own defaults, but drawn from a generator so that a model is a function of
``opt.seed`` and leaves the global RNG alone.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn


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
