"""The fused SSIM+L1 photometric loss as Hopper kernels, and its wrappers.

Counterpart of ``sfmnext_tpu/ops/pallas/ssim_kernel.py``: per source the
map 0.85 * mean_c clip((1 - SSIM_7x7) / 2, 0, 1) + 0.15 * mean_c |T - P|,
and the per-pixel min over [identity sources..., warped sources...] with
the automask (reference trainer.py:441-530).

  * ``ssim_fwd``       -> ``ssim_fwd`` in ``csrc/ssim_kernel.cu`` (replaces
    ``_call_fwd`` / ``_fwd_kernel``), counted in ``ssim_fwd.launches``;
  * ``ssim_ident_min`` -> ``ssim_ident_min`` (replaces ``_call_ident_min``
    / ``_ident_min_kernel``), counted in ``ssim_ident_min.launches``;
  * ``ssim_bwd``       -> ``ssim_bwd`` (replaces ``_call_bwd`` /
    ``_bwd_kernel``), counted in ``ssim_bwd.launches``.

The entry points are ``reprojection_losses`` (the maps, differentiable in
the predictions), ``identity_losses`` (the maps of the unwarped sources,
no gradient: ``ssim_fwd`` standing in for ``_call_fwd_only`` /
``_fwd_only_kernel``, which it computes exactly since it keeps no
residuals; counted in ``identity_losses.launches`` as well) and
``reprojection_min`` (the min and the automask, differentiable in the
warped sources). The images are NHWC float32, as the
warp writes them; ``loss_dtype`` bfloat16 rounds them to bf16 as the
kernels load them. Only the warped sources get a gradient: the target, the
identity sources and the noise are data.

The plain versions (``plain_maps``, ``plain_ident_min``, ``plain_bwd``)
round the inputs to the loss dtype and then run ``ops/losses`` in float32,
so in float32 they are the XLA path of the JAX package; the Pallas kernels
also round p*p and the first box pass to bf16, which these do not. A CPU
tensor takes them; a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import torch

from sfmnext_tpu_torch.ops import _build, losses as L

MAX_SOURCES = 8  # kMaxSrc in csrc/ssim_kernel.cu


def _rounded(x: torch.Tensor, loss_dtype) -> torch.Tensor:
    return x if loss_dtype == torch.float32 else x.to(loss_dtype).float()


def plain_maps(srcs, target, ssim_weight: float = 0.85, loss_dtype=torch.bfloat16):
    """[B,H,W,N] float32 loss maps of N sources [B,H,W,3] against target."""
    return L.reprojection_losses_stacked(
        [_rounded(p, loss_dtype) for p in srcs], _rounded(target, loss_dtype), ssim_weight)


def plain_ident_min(idents, target, noise, rmaps, ssim_weight: float = 0.85,
                    loss_dtype=torch.bfloat16):
    """The identity maps plus noise folded with the warped maps ``rmaps``
    [B,H,W,N]: (min [B,H,W] float32, arg [B,H,W] int32) in the order
    [ident..., reproj...], the first minimum winning; arg = N + m for
    identity m, k for warped source k."""
    ident = plain_maps(idents, target, ssim_weight, loss_dtype)
    if noise is not None:
        ident = ident + noise
    n = rmaps.shape[-1]
    best = ident[..., 0]
    arg = torch.full(best.shape, n, dtype=torch.int32, device=best.device)
    candidates = [(ident[..., m], n + m) for m in range(1, ident.shape[-1])]
    candidates += [(rmaps[..., k], k) for k in range(n)]
    for value, index in candidates:
        better = value < best
        best = torch.where(better, value, best)
        arg = torch.where(better, index, arg)
    return best, arg


def plain_bwd(preds, target, g, arg=None, ssim_weight: float = 0.85, loss_dtype=torch.bfloat16):
    """d(sum(maps * cotangent))/d(preds): the cotangent is g [B,H,W,N], or
    with ``arg`` the min's g [B,H,W] given to the source that won."""
    ps = [p.detach().requires_grad_() for p in preds]
    with torch.enable_grad():
        maps = plain_maps(ps, target.detach(), ssim_weight, loss_dtype)
    if arg is not None:
        won = arg[..., None] == torch.arange(len(ps), device=arg.device, dtype=arg.dtype)
        g = g[..., None] * won.to(g.dtype)
    return torch.autograd.grad(maps, ps, g)


def _check(srcs, target, loss_dtype):
    _build.require(loss_dtype in (torch.float32, torch.bfloat16),
                   f"loss_dtype must be float32 or bfloat16, got {loss_dtype}")
    _build.require(1 <= len(srcs) <= MAX_SOURCES,
                   f"{len(srcs)} sources: the kernels take 1 to {MAX_SOURCES}")
    _build.require(target.dim() == 4 and target.shape[-1] == 3,
                   f"target must be [B,H,W,3], got {tuple(target.shape)}")
    _, h, w, _ = target.shape
    _build.require(h >= 4 and w >= 4, f"target {tuple(target.shape)}: the 7x7 reflect "
                                      "window needs H and W >= 4")
    _build.check_tensor("target", target, torch.float32, target.shape)
    for i, src in enumerate(srcs):
        _build.check_tensor(f"source {i}", src, torch.float32, target.shape)
    return _build.kernel_device(target, *srcs)


def ssim_fwd(preds, target, ssim_weight: float = 0.85, loss_dtype=torch.bfloat16):
    """The forward kernel: N sources [B,H,W,3] float32 against target ->
    [B,H,W,N] float32 loss maps (no autograd)."""
    dev = _check(preds, target, loss_dtype)
    if dev.type == "cpu":
        return plain_maps(preds, target, ssim_weight, loss_dtype)
    b, h, w, _ = target.shape
    maps = torch.empty((b, h, w, len(preds)), device=dev, dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.ssim_fwd(_build.pointer_array(preds), target.data_ptr(), maps.data_ptr(),
                           b, len(preds), h, w, int(loss_dtype == torch.bfloat16),
                           float(ssim_weight), _build.stream(dev))
    _build.check_error(lib, err, "ssim_fwd")
    ssim_fwd.launches += 1
    return maps


def ssim_ident_min(idents, target, noise, rmaps, ssim_weight: float = 0.85,
                   loss_dtype=torch.bfloat16):
    """The identity-min kernel: M identity sources [B,H,W,3] float32, noise
    [1,H,W,M] float32 or None, the warped maps rmaps [B,H,W,N] float32 ->
    (min [B,H,W] float32, arg [B,H,W] int32), as ``plain_ident_min``."""
    dev = _check(idents, target, loss_dtype)
    b, h, w, _ = target.shape
    _build.require(rmaps.dim() == 4 and tuple(rmaps.shape[:3]) == (b, h, w)
                   and 1 <= rmaps.shape[3] <= MAX_SOURCES,
                   f"rmaps must be [B,H,W,N<={MAX_SOURCES}], got {tuple(rmaps.shape)}")
    _build.check_tensor("rmaps", rmaps, torch.float32, rmaps.shape)
    tensors = [target, rmaps]
    if noise is not None:
        _build.check_tensor("noise", noise, torch.float32, (1, h, w, len(idents)))
        tensors.append(noise)
    _build.kernel_device(*tensors)
    if dev.type == "cpu":
        return plain_ident_min(idents, target, noise, rmaps, ssim_weight, loss_dtype)
    n = rmaps.shape[3]
    out_min = torch.empty((b, h, w), device=dev, dtype=torch.float32)
    out_arg = torch.empty((b, h, w), device=dev, dtype=torch.int32)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.ssim_ident_min(_build.pointer_array(idents), target.data_ptr(),
                                 None if noise is None else noise.data_ptr(), rmaps.data_ptr(),
                                 out_min.data_ptr(), out_arg.data_ptr(), b, len(idents), n, h, w,
                                 int(loss_dtype == torch.bfloat16), float(ssim_weight),
                                 _build.stream(dev))
    _build.check_error(lib, err, "ssim_ident_min")
    ssim_ident_min.launches += 1
    return out_min, out_arg


def ssim_bwd(preds, target, g, arg=None, ssim_weight: float = 0.85, loss_dtype=torch.bfloat16):
    """The backward kernel: the gradient of the N maps for the cotangent g
    [B,H,W,N] float32, or, with ``arg`` [B,H,W] int32, for the min's g
    [B,H,W] float32 routed to the winners -> N tensors [B,H,W,3] float32."""
    dev = _check(preds, target, loss_dtype)
    b, h, w, _ = target.shape
    n = len(preds)
    if arg is None:
        _build.check_tensor("g", g, torch.float32, (b, h, w, n))
        _build.kernel_device(target, g)
    else:
        _build.check_tensor("g", g, torch.float32, (b, h, w))
        _build.check_tensor("arg", arg, torch.int32, (b, h, w))
        _build.kernel_device(target, g, arg)
    if dev.type == "cpu":
        return plain_bwd(preds, target, g, arg, ssim_weight, loss_dtype)
    dps = [torch.empty_like(p) for p in preds]
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.ssim_bwd(_build.pointer_array(preds), _build.pointer_array(dps),
                           target.data_ptr(), g.data_ptr(),
                           None if arg is None else arg.data_ptr(), b, n, h, w,
                           int(loss_dtype == torch.bfloat16), float(ssim_weight),
                           _build.stream(dev))
    _build.check_error(lib, err, "ssim_bwd")
    ssim_bwd.launches += 1
    return tuple(dps)


ssim_fwd.launches = 0
ssim_ident_min.launches = 0
ssim_bwd.launches = 0


class _ReprojectionLosses(torch.autograd.Function):
    @staticmethod
    def forward(ctx, target, ssim_weight, loss_dtype, *preds):
        ctx.save_for_backward(target, *preds)
        ctx.config = (ssim_weight, loss_dtype)
        return ssim_fwd(preds, target, ssim_weight, loss_dtype)

    @staticmethod
    def backward(ctx, g):
        target, *preds = ctx.saved_tensors
        dps = ssim_bwd(preds, target, g.contiguous(), None, *ctx.config)
        return (None, None, None, *dps)


class _ReprojectionMin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, target, noise, ssim_weight, loss_dtype, n_grad, *srcs):
        preds, idents = srcs[:n_grad], srcs[n_grad:]
        maps = ssim_fwd(preds, target, ssim_weight, loss_dtype)
        out_min, arg = ssim_ident_min(idents, target, noise, maps, ssim_weight, loss_dtype)
        ctx.save_for_backward(target, arg, *preds)
        ctx.config = (ssim_weight, loss_dtype)
        ctx.n_ident = len(idents)
        ctx.mark_non_differentiable(arg)
        return out_min, arg

    @staticmethod
    def backward(ctx, g, _):
        target, arg, *preds = ctx.saved_tensors
        dps = ssim_bwd(preds, target, g.contiguous(), arg, *ctx.config)
        return (None,) * 5 + tuple(dps) + (None,) * ctx.n_ident


def reprojection_losses(preds, target, ssim_weight: float = 0.85, loss_dtype=torch.bfloat16):
    """Per-source loss maps [B,H,W,N] float32 of N predictions [B,H,W,3]
    against target (counterpart of ``reprojection_losses_pallas``);
    differentiable in the predictions."""
    return _ReprojectionLosses.apply(target, float(ssim_weight), loss_dtype, *preds)


def identity_losses(idents, target, ssim_weight: float = 0.85, loss_dtype=torch.bfloat16):
    """Per-source loss maps [B,H,W,M] float32 of M unwarped sources
    [B,H,W,3] against target, with no gradient (counterpart of
    ``reprojection_losses_pallas(need_grad=False)``): the identity stack of
    a step that does not fold it into the min (``--avg_reprojection``)."""
    with torch.no_grad():
        maps = ssim_fwd(idents, target, ssim_weight, loss_dtype)
    if maps.device.type == "cuda":  # ssim_fwd launched its kernel
        identity_losses.launches += 1
    return maps


identity_losses.launches = 0


def reprojection_min(preds, idents, target, noise=None, ssim_weight: float = 0.85,
                     loss_dtype=torch.bfloat16):
    """The min over [identity maps + noise..., warped maps...] with the
    automask (counterpart of ``reprojection_min_pallas``).

    Args:
      preds: N warped sources [B,H,W,3] float32 (gradients flow).
      idents: M unwarped sources [B,H,W,3] float32 (data).
      target: [B,H,W,3] float32 (data).
      noise: [1,H,W,M] float32 identity tie-break noise, or None.
    Returns:
      (to_optimise [B,H,W] float32, automask [B,H,W] float32: 1 where a
      warped source won; an identity takes a tie).
    """
    out_min, arg = _ReprojectionMin.apply(target, noise, float(ssim_weight), loss_dtype,
                                          len(preds), *preds, *idents)
    return out_min, (arg < len(preds)).float()
