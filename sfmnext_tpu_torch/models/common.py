"""Weight initialisation from an explicit ``torch.Generator``, and the
BatchNorm of the JAX package.

Counterpart of the initialisers in ``sfmnext_tpu/models/common.py``: torch's
own defaults, and the JAX package's truncated-normal variance scalings
(flax's ``lecun_normal``, ``kaiming_normal_fanout``), drawn from a
generator so that a model is a function of ``opt.seed`` and leaves the
global RNG alone.
"""

from __future__ import annotations

import contextlib
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

    recomputing = False  # set by ``batchnorm_recompute``

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if self.recomputing:
            # the same op on copies of the buffers: the same output and the
            # same tensors saved for the backward, the buffers untouched
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(),
                                self.weight, self.bias, True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        new_var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, new_var, self.weight, self.bias,
                         True, self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.mul_((1 - self.momentum) / n).add_(new_var, alpha=(n - 1) / n)
            self.num_batches_tracked.add_(1)
        return y


@contextlib.contextmanager
def batchnorm_recompute(module: nn.Module):
    """``module``'s BatchNorms normalise by the batch's statistics and leave
    their running statistics and counts alone while the context is open:
    the recompute of an activation checkpoint (``torch.utils.checkpoint``'s
    ``context_fn``), so that the statistics move once a step, as under
    ``jax.checkpoint``, whose ``batch_stats`` come out of the forward once."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.recomputing = True
    try:
        yield
    finally:
        for m in norms:
            m.recomputing = False


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


class GroupNorm32(nn.GroupNorm):
    """flax's ``nn.GroupNorm(num_groups=32, epsilon=1e-5)``: statistics and
    affine in float32 whatever the input's dtype, the output in it."""

    def __init__(self, channels: int):
        super().__init__(32, channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), 32, self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class SEModule(nn.Module):
    """Squeeze-and-excitation (``se_module`` of the JAX package): global
    mean -> 1x1 ``fc1`` -> ReLU -> 1x1 ``fc2`` -> sigmoid gate on the
    channels. timm's names (``se.fc1`` / ``se.fc2``)."""

    def __init__(self, channels: int, rd_channels: int):
        super().__init__()
        self.fc1 = flax_default(nn.Conv2d(channels, rd_channels, 1))
        self.fc2 = flax_default(nn.Conv2d(rd_channels, channels, 1))

    def forward(self, x):
        s = self.fc2(F.relu(self.fc1(x.mean((2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class EcaModule(nn.Module):
    """Efficient channel attention (``eca_module``, ECA-Net): global mean,
    a 1-D convolution across the channels with an odd kernel from C
    (gamma 2, beta 1, at least 3), sigmoid gate. timm's name ``se.conv``."""

    def __init__(self, channels: int):
        super().__init__()
        t = int(abs((math.log2(channels) + 1.0) / 2.0))
        k = max(t if t % 2 else t + 1, 3)
        self.conv = flax_default(nn.Conv1d(1, 1, k, padding=k // 2, bias=False))

    def forward(self, x):
        s = self.conv(x.mean((2, 3))[:, None, :])  # [B,1,C]: the channels as the 1-D axis
        return x * torch.sigmoid(s).view(x.shape[0], -1, 1, 1)


def avg_pool_2x2_s2_ceil(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(2, 2, ceil_mode=True, count_include_pad=False): the
    avg-down shortcut's pool (resnet*d, gluon v1d, ResNeSt)."""
    return F.avg_pool2d(x, 2, 2, ceil_mode=True, count_include_pad=False)


def blur_pool(x: torch.Tensor) -> torch.Tensor:
    """Anti-aliased stride-2 downsample (``blur_pool`` of the JAX package):
    the binomial [1,2,1]x[1,2,1]/16 filter on every channel, zero padding
    1, stride 2."""
    f1 = torch.tensor([1.0, 2.0, 1.0], dtype=x.dtype, device=x.device)
    k = (f1[:, None] * f1[None, :] / 16.0).expand(x.shape[1], 1, 3, 3)
    return F.conv2d(x, k, stride=2, padding=1, groups=x.shape[1])


class AAPool(nn.Module):
    """The anti-aliased stride (``_aa_pool``): ``blur`` (resnetblur*) or
    ``avg``, a 2x2 stride-2 average (resnetaa*, seresnextaa*)."""

    def __init__(self, kind: str):
        super().__init__()
        if kind not in ("blur", "avg"):
            raise ValueError(f"anti-aliasing {kind!r}: 'blur' or 'avg'")
        self.kind = kind

    def forward(self, x):
        return blur_pool(x) if self.kind == "blur" else F.avg_pool2d(x, 2, 2)


class AvgPool2x2Ceil(nn.Module):
    def forward(self, x):
        return avg_pool_2x2_s2_ceil(x)


def flax_default(conv: nn.Module) -> nn.Module:
    """Mark a convolution whose JAX module takes flax's default init
    (``lecun_normal``, zero bias) for ``jax_init_``."""
    conv.flax_default_init = True
    return conv


@torch.no_grad()
def jax_init_(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's init of a convolutional trunk, module by module:
    convolutions ``kaiming_normal_fanout`` but those marked by
    ``flax_default`` (``lecun_normal``), zero biases; BatchNorm and
    GroupNorm 1 / 0 with fresh running statistics."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv1d)):
            if getattr(m, "flax_default_init", False):
                lecun_normal_(m.weight, generator)
            else:
                kaiming_normal_fanout_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
            m.reset_parameters()
