"""The bilinear warp as Hopper kernels, and its wrappers.

Counterpart of ``warp_border_pallas`` and ``warp_sample_pallas`` in
``sfmnext_tpu/ops/pallas/warp_kernel.py``: a bilinear sample of an NHWC
image at pixel coordinates, in border or zeros padding, differentiable in
the coordinates and, where the sampled tensor carries gradients, in the
image.

  * ``warp_fwd``     -> ``warp_fwd`` in ``csrc/warp_kernel.cu`` (replaces
    ``_call_fwd`` / ``_fwd_kernel``);
  * ``warp_bwd``     -> ``warp_bwd`` (replaces ``_call_bwd_coords`` /
    ``_bwd_kernel``), the coordinate gradient;
  * ``warp_bwd_img`` -> ``warp_bwd_img`` (replaces ``_call_bwd_img`` /
    ``_bwd_img_kernel``), the image gradient.

All three are bound by the bytes they move (float32: the image, the
coordinates, the cotangent and the outputs, each once). The forward and
the coordinate gradient take four output pixels a thread (consecutive in
border padding, 32 apart in zeros padding), the batch on the grid's y axis
and 32-bit offsets inside one image plane and one output plane, with C = 1
and 3 compiled in (``csrc/warp_kernel.cu`` says why). So the wrappers
raise on an image plane of 2^31 floats or more, on an output plane that
reaches 2^31 floats once rounded up by one block's ``BLOCK_PIXELS``, and
on more than 65,535 images. Each counts its launches per padding mode in
``<wrapper>.launches`` (``{"border": n, "zeros": n}``). The entry point is
``warp_sample``. The plain versions are ``ops/warp.sample_border`` and
``ops/warp.sample_zeros``: a CPU tensor takes them in the forward and
autograd's gradients of them in the backward; a CUDA tensor launches the
kernels or raises.
"""

from __future__ import annotations

import torch

from sfmnext_tpu_torch.ops import _build, warp

MODES = ("border", "zeros")
MAX_BATCH = 65535  # the CUDA grid's y extent
BLOCK_PIXELS = 512  # output pixels a block of warp_fwd / warp_bwd (kThreads * kPix)


def _mode(zeros: bool) -> str:
    return MODES[int(bool(zeros))]


def _check_coords(shape, fy, fx):
    """The image's shape (a tuple: nothing is allocated) and the coordinates
    as the kernels take them: the batch on the grid's y axis (at most
    65,535), 32-bit offsets inside one image plane and one output plane
    (whose pixel indices run up to one block's pixels past its end before
    their bounds test)."""
    b, h, w, c = shape
    _build.require(h >= 2 and w >= 2, f"image {tuple(shape)}: H and W must be >= 2")
    _build.require(b <= MAX_BATCH, f"image {tuple(shape)}: at most {MAX_BATCH} images")
    _build.require(h * w * c < 2**31, f"image {tuple(shape)}: H*W*C must be below 2^31")
    _build.require(fy.dim() == 3 and fy.shape[0] == b,
                   f"fy must be [B={b},Ho,Wo], got {tuple(fy.shape)}")
    _build.require((fy.shape[1] * fy.shape[2] + BLOCK_PIXELS) * c < 2**31,
                   f"output {(*fy.shape, c)}: (Ho*Wo + {BLOCK_PIXELS})*C must be below 2^31")
    _build.check_tensor("fy", fy, torch.float32, fy.shape)
    _build.check_tensor("fx", fx, torch.float32, fy.shape)


def _check(img, fy, fx):
    _build.require(img.dim() == 4, f"img must be [B,H,W,C], got {tuple(img.shape)}")
    _check_coords(img.shape, fy, fx)
    _build.check_tensor("img", img, torch.float32, img.shape)
    return _build.kernel_device(img, fy, fx)


def _plain(img, fy, fx, zeros):
    return (warp.sample_zeros if zeros else warp.sample_border)(img, fy, fx)


def warp_fwd(img: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor,
             zeros: bool = False) -> torch.Tensor:
    """The forward kernel: img [B,H,W,C] float32 sampled at fy/fx [B,Ho,Wo]
    float32 -> [B,Ho,Wo,C] float32 (no autograd)."""
    dev = _check(img, fy, fx)
    if dev.type == "cpu":
        return _plain(img, fy, fx, zeros)
    b, h, w, c = img.shape
    out = torch.empty((*fy.shape, c), device=dev, dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.warp_fwd(img.data_ptr(), fy.data_ptr(), fx.data_ptr(), out.data_ptr(),
                           b, h, w, c, fy.shape[1], fy.shape[2], int(zeros), _build.stream(dev))
    _build.check_error(lib, err, "warp_fwd")
    warp_fwd.launches[_mode(zeros)] += 1
    return out


def warp_bwd(img, fy, fx, g, zeros: bool = False):
    """The coordinate gradient of ``warp_fwd`` for the output cotangent g
    [B,Ho,Wo,C] float32 -> (dfy, dfx) [B,Ho,Wo] float32; in border mode
    zero where a coordinate is clamped to the border."""
    dev = _check(img, fy, fx)
    _build.check_tensor("g", g, torch.float32, (*fy.shape, img.shape[3]))
    _build.require(g.device == dev, "g lies on another device")
    if dev.type == "cpu":
        fy_, fx_ = fy.detach().requires_grad_(), fx.detach().requires_grad_()
        with torch.enable_grad():
            out = _plain(img.detach(), fy_, fx_, zeros)
        return torch.autograd.grad(out, (fy_, fx_), g)
    b, h, w, c = img.shape
    dfy = torch.empty_like(fy)
    dfx = torch.empty_like(fx)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.warp_bwd(img.data_ptr(), fy.data_ptr(), fx.data_ptr(), g.data_ptr(),
                           dfy.data_ptr(), dfx.data_ptr(), b, h, w, c,
                           fy.shape[1], fy.shape[2], int(zeros), _build.stream(dev))
    _build.check_error(lib, err, "warp_bwd")
    warp_bwd.launches[_mode(zeros)] += 1
    return dfy, dfx


def warp_bwd_img(fy, fx, g, img_shape, zeros: bool = False) -> torch.Tensor:
    """The image gradient of ``warp_fwd`` for the output cotangent g
    [B,Ho,Wo,C] float32 -> dimg of ``img_shape`` [B,H,W,C] float32: every
    sample adds g times each corner's bilinear weight to that corner (the
    corners outside the image dropped in zeros mode)."""
    _build.require(len(img_shape) == 4, f"img_shape must be [B,H,W,C], got {tuple(img_shape)}")
    _check_coords(img_shape, fy, fx)
    _build.check_tensor("g", g, torch.float32, (*fy.shape, img_shape[3]))
    dev = _build.kernel_device(fy, fx, g)
    if dev.type == "cpu":
        img = torch.zeros(img_shape, dtype=torch.float32, requires_grad=True)
        with torch.enable_grad():
            out = _plain(img, fy.detach(), fx.detach(), zeros)
        return torch.autograd.grad(out, img, g)[0]
    b, h, w, c = img_shape
    dimg = torch.empty(tuple(img_shape), device=dev, dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.warp_bwd_img(fy.data_ptr(), fx.data_ptr(), g.data_ptr(), dimg.data_ptr(),
                               b, h, w, c, fy.shape[1], fy.shape[2], int(zeros),
                               _build.stream(dev))
    _build.check_error(lib, err, "warp_bwd_img")
    warp_bwd_img.launches[_mode(zeros)] += 1
    return dimg


warp_fwd.launches = dict.fromkeys(MODES, 0)
warp_bwd.launches = dict.fromkeys(MODES, 0)
warp_bwd_img.launches = dict.fromkeys(MODES, 0)


class _WarpSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, fy, fx, zeros):
        ctx.save_for_backward(img, fy, fx)
        ctx.zeros = zeros
        return warp_fwd(img, fy, fx, zeros)

    @staticmethod
    def backward(ctx, g):
        img, fy, fx = ctx.saved_tensors
        g = g.contiguous()
        dfy, dfx = warp_bwd(img, fy, fx, g, ctx.zeros)
        # a sampled frame is data: its cotangent is neither needed nor made
        dimg = (warp_bwd_img(fy, fx, g, img.shape, ctx.zeros)
                if ctx.needs_input_grad[0] else None)
        return dimg, dfy, dfx, None


def warp_sample(img: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor,
                zeros: bool = False) -> torch.Tensor:
    """Bilinear sample of img [B,H,W,C] float32 at pixel coordinates fy/fx
    [B,Ho,Wo] float32 -> [B,Ho,Wo,C], border or (``zeros``) zeros padding;
    differentiable in fy, fx and, when it requires a gradient, img."""
    return _WarpSample.apply(img, fy, fx, bool(zeros))
