"""Bilinear image sampling and the view-synthesis warp, plain PyTorch.

Counterpart of ``sfmnext_tpu/ops/warp.py`` (``grid_sample`` in border
mode and ``warp_frame``), with its NHWC image layout and normalised
``[B,Ho,Wo,2]`` (x, y) grids. ``sample_border`` is the explicit
gather-and-lerp of the JAX package (warp.py:92-107), differentiated by
autograd: the plain version of the warp kernels in ``ops/warp_kernel.py``,
and the path of the unfused step.
"""

from __future__ import annotations

import torch

from sfmnext_tpu_torch.ops import geometry


def unnormalize(grid: torch.Tensor, h: int, w: int, align_corners: bool = True):
    """Normalised (x, y) grid [...,2] -> pixel coordinates (fx, fy)."""
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        return (gx + 1.0) * 0.5 * (w - 1), (gy + 1.0) * 0.5 * (h - 1)
    return ((gx + 1.0) * w - 1.0) * 0.5, ((gy + 1.0) * h - 1.0) * 0.5


def sample_border(img: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
    """Bilinear border-mode sample of img [B,H,W,C] at pixel coordinates
    fy/fx [B,Ho,Wo] -> [B,Ho,Wo,C].

    Coordinates clamp into the image before the corner split, so the four
    corners form one 2x2 window (torch's border semantics); clamped
    coordinates get no gradient. H and W must be at least 2.
    """
    b, h, w, c = img.shape
    fyc = fy.clamp(0.0, h - 1)
    fxc = fx.clamp(0.0, w - 1)
    y0 = torch.floor(fyc).clamp(0, h - 2)
    x0 = torch.floor(fxc).clamp(0, w - 2)
    wy = (fyc - y0)[..., None]
    wx = (fxc - x0)[..., None]
    flat = img.reshape(b, h * w, c)
    base = (y0.long() * w + x0.long()).reshape(b, -1)

    def corner(offset):
        idx = (base + offset)[..., None].expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(*fy.shape, c)

    top = corner(0) * (1 - wx) + corner(1) * wx
    bot = corner(w) * (1 - wx) + corner(w + 1) * wx
    return top * (1 - wy) + bot * wy


def grid_sample(img, grid, padding_mode: str = "border", align_corners: bool = True):
    """Bilinear sample of img [B,H,W,C] at normalised grid [B,Ho,Wo,2];
    torch's ``F.grid_sample`` semantics. Border padding only: zeros
    padding (the indoor warps) is not ported."""
    if padding_mode != "border":
        raise NotImplementedError(f"padding_mode {padding_mode!r}: the port has 'border'")
    _, h, w, _ = img.shape
    fx, fy = unnormalize(grid, h, w, align_corners)
    return sample_border(img, fy, fx)


def warp_frame(src_img, depth, inv_K, K, T, use_kernel: bool = False):
    """Backproject the target depth, move it by T, project it, and sample
    the source frame there (border padding, align_corners=True).

    Args:
      src_img: [B,H,W,C] source frame (data: it gets no gradient on the
        kernel path, as in the JAX package's ``warp_border_pallas``).
      depth: [B,H,W,1] target-frame depth; inv_K, K, T: [B,4,4].
      use_kernel: sample through ``ops/warp_kernel.warp_border`` (the
        Hopper kernels on a CUDA tensor) instead of ``sample_border``.
    Returns:
      (warped [B,H,W,C], pix_coords [B,H,W,2]).
    """
    _, h, w, _ = depth.shape
    cam_points = geometry.backproject_depth(depth, inv_K)
    pix_coords = geometry.project_3d(cam_points, K, T, h, w)
    if use_kernel:
        from sfmnext_tpu_torch.ops import warp_kernel

        fx, fy = unnormalize(pix_coords, h, w)
        warped = warp_kernel.warp_border(src_img, fy, fx)
    else:
        warped = grid_sample(src_img, pix_coords)
    return warped, pix_coords
