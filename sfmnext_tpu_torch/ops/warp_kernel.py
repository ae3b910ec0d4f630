"""The view-synthesis warp as Hopper kernels, and its wrapper.

Counterpart of ``warp_border_pallas`` in
``sfmnext_tpu/ops/pallas/warp_kernel.py``: a bilinear border-mode sample
of an NHWC image at pixel coordinates whose gradient flows to the
coordinates only (the sampled frame is training data).

  * forward  -> ``warp_border_fwd`` in ``csrc/warp_kernel.cu`` (replaces
    ``_call_fwd`` / ``_fwd_kernel``), counted in ``warp_border.launches``;
  * backward -> ``warp_border_bwd`` (replaces ``_call_bwd_coords`` /
    ``_bwd_kernel``), counted in ``warp_border_bwd.launches``.

The plain version is ``ops/warp.sample_border``: a CPU tensor takes it in
the forward and autograd's gradient of it in the backward; a CUDA tensor
launches the kernels or raises. The image gets no gradient either way.
"""

from __future__ import annotations

import torch

from sfmnext_tpu_torch.ops import _build, warp


def _check(img, fy, fx):
    _build.require(img.dim() == 4, f"img must be [B,H,W,C], got {tuple(img.shape)}")
    b, h, w, c = img.shape
    _build.require(h >= 2 and w >= 2, f"img {tuple(img.shape)}: H and W must be >= 2")
    _build.require(fy.dim() == 3 and fy.shape[0] == b,
                   f"fy must be [B={b},Ho,Wo], got {tuple(fy.shape)}")
    _build.check_tensor("img", img, torch.float32, (b, h, w, c))
    _build.check_tensor("fy", fy, torch.float32, fy.shape)
    _build.check_tensor("fx", fx, torch.float32, fy.shape)
    return _build.kernel_device(img, fy, fx)


def warp_border_fwd(img: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
    """The forward kernel: img [B,H,W,C] float32 sampled at fy/fx
    [B,Ho,Wo] float32 -> [B,Ho,Wo,C] float32 (no autograd)."""
    dev = _check(img, fy, fx)
    if dev.type == "cpu":
        return warp.sample_border(img, fy, fx)
    b, h, w, c = img.shape
    out = torch.empty((*fy.shape, c), device=dev, dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.warp_border_fwd(img.data_ptr(), fy.data_ptr(), fx.data_ptr(), out.data_ptr(),
                                  b, h, w, c, fy.shape[1], fy.shape[2], _build.stream(dev))
    _build.check_error(lib, err, "warp_border_fwd")
    warp_border.launches += 1
    return out


def warp_border_bwd(img, fy, fx, g):
    """The coordinate gradient of ``warp_border_fwd`` for the output
    cotangent g [B,Ho,Wo,C] float32 -> (dfy, dfx) [B,Ho,Wo] float32; zero
    where a coordinate is clamped to the border."""
    dev = _check(img, fy, fx)
    _build.check_tensor("g", g, torch.float32, (*fy.shape, img.shape[3]))
    _build.require(g.device == dev, "g lies on another device")
    if dev.type == "cpu":
        fy_, fx_ = fy.detach().requires_grad_(), fx.detach().requires_grad_()
        with torch.enable_grad():
            out = warp.sample_border(img.detach(), fy_, fx_)
        return torch.autograd.grad(out, (fy_, fx_), g)
    b, h, w, c = img.shape
    dfy = torch.empty_like(fy)
    dfx = torch.empty_like(fx)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.warp_border_bwd(img.data_ptr(), fy.data_ptr(), fx.data_ptr(), g.data_ptr(),
                                  dfy.data_ptr(), dfx.data_ptr(), b, h, w, c,
                                  fy.shape[1], fy.shape[2], _build.stream(dev))
    _build.check_error(lib, err, "warp_border_bwd")
    warp_border_bwd.launches += 1
    return dfy, dfx


warp_border_bwd.launches = 0


class _WarpBorder(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, fy, fx):
        ctx.save_for_backward(img, fy, fx)
        return warp_border_fwd(img, fy, fx)

    @staticmethod
    def backward(ctx, g):
        img, fy, fx = ctx.saved_tensors
        dfy, dfx = warp_border_bwd(img, fy, fx, g.contiguous())
        return None, dfy, dfx  # the image cotangent is zero


def warp_border(img: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
    """Bilinear border-mode sample of img [B,H,W,C] float32 at pixel
    coordinates fy/fx [B,Ho,Wo] float32 -> [B,Ho,Wo,C]; differentiable in
    fy and fx."""
    return _WarpBorder.apply(img, fy, fx)


warp_border.launches = 0
