"""The on-device ColorJitter as a Hopper kernel, its wrapper and its plain
version.

Counterpart of ``color_jitter_pallas_cf`` in
``sfmnext_tpu/ops/pallas/jitter_kernel.py``, which ``augment_batch`` calls
on the TPU: ``color_jitter`` -> ``color_jitter`` in
``csrc/jitter_kernel.cu`` (replaces ``color_jitter_pallas_cf`` /
``_kernel``), counted in ``color_jitter.launches``. It takes the NHWC
stack [B,F,H,W,3] as the batch holds it; the Pallas kernel's channel-first
planes were a TPU layout.

The plain version is ``plain_color_jitter``, torchvision-style ColorJitter
(the JAX package's ``data/augment.py``; reference datasets/
mono_dataset.py:177-180): brightness x * f; contrast, a blend with the
frame's grayscale mean; saturation, a blend with the per-pixel grayscale;
hue, an HSV hue shift; a clamp to [0, 1] after each op. A CPU tensor takes
it, a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from sfmnext_tpu_torch.ops import _build

CLUSTER = 16  # blocks a cluster: kCluster in csrc/jitter_kernel.cu

_GRAY = (0.299, 0.587, 0.114)


def _gray(img):
    return img[..., 0:1] * _GRAY[0] + img[..., 1:2] * _GRAY[1] + img[..., 2:3] * _GRAY[2]


def _blend(a, b, f):
    return torch.clamp(f * a + (1.0 - f) * b, 0.0, 1.0)


def adjust_brightness(img, f):
    return torch.clamp(img * f, 0.0, 1.0)


def adjust_contrast(img, f):
    """Blend with the mean of each frame's grayscale image ([..., H, W, 3])."""
    return _blend(img, _gray(img).mean(dim=(-3, -2), keepdim=True), f)


def adjust_saturation(img, f):
    return _blend(img, _gray(img), f)


def _rgb_to_hsv(img):
    r, g, b = img.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-8), 0.0)
    safe = torch.where(delta > 0, delta, 1.0)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)  # floor-mod: non-negative for negative h
    return torch.where(delta > 0, h, 0.0), s, maxc


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = i.to(torch.int32) % 6  # h * 6 can round up to 6

    def pick(cases):
        out = cases[5]
        for idx in range(4, -1, -1):
            out = torch.where(i == idx, cases[idx], out)
        return out

    return torch.stack([pick([v, q, p, p, t, v]), pick([t, v, v, q, p, p]),
                        pick([p, p, t, v, v, q])], dim=-1)


def adjust_hue(img, shift):
    h, s, v = _rgb_to_hsv(img)
    h = torch.remainder(h + shift, 1.0)
    return torch.clamp(_hsv_to_rgb(h, s, v), 0.0, 1.0)


_OPS = (adjust_brightness, adjust_contrast, adjust_saturation, adjust_hue)


def plain_color_jitter(color, order, factors, do_jit):
    """ColorJitter of a batch of frame stacks: color [B,F,H,W,3] float32 in
    [0,1]; sample b runs op order[b, j] (0 brightness, 1 contrast, 2
    saturation, 3 hue) with factor factors[b, op] for j = 0..3 where
    do_jit[b], and is copied unchanged where not. Every op is computed for
    every sample and the sample's own selected, as ``jax.vmap`` runs the
    JAX version."""
    shape = (-1,) + (1,) * (color.dim() - 1)
    out = color
    for j in range(4):
        op = order[:, j].reshape(shape)
        step = out
        for k, fn in enumerate(_OPS):
            f = factors[:, k].reshape(shape[:-1]) if k == 3 else factors[:, k].reshape(shape)
            step = torch.where(op == k, fn(out, f), step)
        out = step
    return torch.where(do_jit.reshape(shape), out, color)


def color_jitter(color: torch.Tensor, order: torch.Tensor, factors: torch.Tensor,
                 do_jit: torch.Tensor) -> torch.Tensor:
    """ColorJitter of color [B,F,H,W,3] float32 in [0,1] with per-sample op
    order [B,4] int32, factors [B,4] float32 and do_jit [B] bool, as
    ``plain_color_jitter``; a new tensor."""
    _build.require(color.dim() == 5 and color.shape[-1] == 3,
                   f"color must be [B,F,H,W,3], got {tuple(color.shape)}")
    b, f, h, w, _ = color.shape
    _build.check_tensor("color", color, torch.float32, color.shape)
    _build.check_tensor("order", order, torch.int32, (b, 4))
    _build.check_tensor("factors", factors, torch.float32, (b, 4))
    _build.require(do_jit.dtype == torch.bool and tuple(do_jit.shape) == (b,),
                   f"do_jit must be [B={b}] bool, got {tuple(do_jit.shape)} {do_jit.dtype}")
    dev = _build.kernel_device(color, order, factors, do_jit)
    if dev.type == "cpu":
        return plain_color_jitter(color, order, factors, do_jit)
    ops = torch.cat([order, do_jit.to(torch.int32)[:, None]], dim=1).contiguous()
    out = torch.empty_like(color)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.color_jitter(color.data_ptr(), ops.data_ptr(), factors.data_ptr(),
                               out.data_ptr(), b, f, h, w, _build.stream(dev))
    _build.check_error(lib, err, "color_jitter")
    color_jitter.launches += 1
    return out


color_jitter.launches = 0


def grid(h: int, w: int, device_index: int):
    """The launch ``color_jitter`` makes on the card for frames of h x w:
    (clusters of ``CLUSTER`` blocks, one wave; chunks of 32 groups of a
    block's span kept in shared memory; the span's chunks)."""
    lib = _build.library()
    out = [ctypes.c_int() for _ in range(3)]
    with torch.cuda.device(device_index):
        err = lib.color_jitter_grid(h, w, *[ctypes.byref(x) for x in out])
    _build.check_error(lib, err, "color_jitter_grid")
    return tuple(x.value for x in out)
