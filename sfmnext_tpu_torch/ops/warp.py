"""Bilinear image sampling and the warps built on it, plain PyTorch.

Counterpart of ``sfmnext_tpu/ops/warp.py`` (``grid_sample`` in border and
zeros padding, ``warp_frame``, ``inverse_rotation_warp``), with its NHWC
image layout and normalised ``[B,Ho,Wo,2]`` (x, y) grids.
``sample_border`` and ``sample_zeros`` are the JAX package's XLA
formulations (warp.py:92-142), differentiated by autograd: the plain
versions of the warp kernels in ``ops/warp_kernel.py``, and the path of
the unfused step. With ``use_kernel`` a sample goes through
``warp_kernel.warp_sample`` (the Hopper kernels on a CUDA tensor).
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


def _gather(img, iy, ix):
    """img [B,H,W,C] at integer pixels iy/ix [B,Ho,Wo] -> [B,Ho,Wo,C]."""
    b, h, w, c = img.shape
    idx = (iy.long() * w + ix.long()).reshape(b, -1, 1).expand(-1, -1, c)
    return torch.gather(img.reshape(b, h * w, c), 1, idx).reshape(*iy.shape, c)


def sample_border(img: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
    """Bilinear border-mode sample of img [B,H,W,C] at pixel coordinates
    fy/fx [B,Ho,Wo] -> [B,Ho,Wo,C].

    Coordinates clamp into the image before the corner split, so the four
    corners form one 2x2 window (torch's border semantics); clamped
    coordinates get no gradient. H and W must be at least 2.
    """
    _, h, w, _ = img.shape
    fyc = fy.clamp(0.0, h - 1)
    fxc = fx.clamp(0.0, w - 1)
    y0 = torch.floor(fyc).clamp(0, h - 2)
    x0 = torch.floor(fxc).clamp(0, w - 2)
    wy = (fyc - y0)[..., None]
    wx = (fxc - x0)[..., None]
    top = _gather(img, y0, x0) * (1 - wx) + _gather(img, y0, x0 + 1) * wx
    bot = _gather(img, y0 + 1, x0) * (1 - wx) + _gather(img, y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def sample_zeros(img: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
    """Bilinear zeros-mode sample of img [B,H,W,C] at pixel coordinates
    fy/fx [B,Ho,Wo] -> [B,Ho,Wo,C]: weights from the unclamped floor, and
    each corner outside the image contributes 0 (torch's zeros semantics).
    """
    _, h, w, _ = img.shape
    y0 = torch.floor(fy)
    x0 = torch.floor(fx)
    wy = (fy - y0)[..., None]
    wx = (fx - x0)[..., None]

    def corner(dy, dx):
        yy, xx = y0 + dy, x0 + dx
        inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        v = _gather(img, yy.clamp(0, h - 1), xx.clamp(0, w - 1))
        return v * inside[..., None].to(img.dtype)

    return (corner(0, 0) * (1 - wy) * (1 - wx) + corner(0, 1) * (1 - wy) * wx
            + corner(1, 0) * wy * (1 - wx) + corner(1, 1) * wy * wx)


def grid_sample(img, grid, padding_mode: str = "border", align_corners: bool = True,
                use_kernel: bool = False):
    """Bilinear sample of img [B,H,W,C] at normalised grid [B,Ho,Wo,2];
    torch's ``F.grid_sample`` semantics in ``"border"`` or ``"zeros"``
    padding. ``use_kernel`` samples through ``warp_kernel.warp_sample``
    (float32 image and grid), differentiable in both."""
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"padding_mode {padding_mode!r}: 'border' or 'zeros'")
    zeros = padding_mode == "zeros"
    _, h, w, _ = img.shape
    fx, fy = unnormalize(grid, h, w, align_corners)
    if use_kernel:
        from sfmnext_tpu_torch.ops import warp_kernel

        return warp_kernel.warp_sample(img, fy, fx, zeros)
    return (sample_zeros if zeros else sample_border)(img, fy, fx)


def warp_frame(src_img, depth, inv_K, K, T, use_kernel: bool = False):
    """Backproject the target depth, move it by T, project it, and sample
    the source frame there (border padding, align_corners=True).

    Args:
      src_img: [B,H,W,C] source frame.
      depth: [B,H,W,1] target-frame depth; inv_K, K, T: [B,4,4].
      use_kernel: sample through the Hopper kernels (``grid_sample``).
    Returns:
      (warped [B,H,W,C], pix_coords [B,H,W,2]).
    """
    _, h, w, _ = depth.shape
    cam_points = geometry.backproject_depth(depth, inv_K)
    pix_coords = geometry.project_3d(cam_points, K, T, h, w)
    return grid_sample(src_img, pix_coords, use_kernel=use_kernel), pix_coords


def _intrinsics_3x3_points(depth: torch.Tensor, K3: torch.Tensor) -> torch.Tensor:
    """Depth [B,H,W,1] and intrinsics K3 [B,3,3] -> camera points [B,3,H*W]
    (kornia's depth_to_3d)."""
    b, h, w, _ = depth.shape
    grid = geometry.pixel_grid(h, w, depth.dtype, depth.device)
    rays = torch.einsum("bij,jn->bin", torch.linalg.inv(K3), grid)
    return depth.reshape(b, 1, h * w) * rays


def rotation_grid(rot, intrinsics, h: int, w: int, dtype=torch.float32):
    """The normalised grid [B,H,W,2] (align_corners=True) at which a frame
    of dtype is sampled to re-render it after the rotation rot [B,3] (Euler
    angles) about the camera centre, intrinsics [B,3,3]."""
    b = rot.shape[0]
    proj = torch.matmul(intrinsics, geometry.euler_to_mat(rot))
    ones = torch.ones((b, h, w, 1), dtype=dtype, device=rot.device)
    cam = geometry._transform(proj, _intrinsics_3x3_points(ones, intrinsics))
    xy = cam[:, :2] / (cam[:, 2:3] + 1e-7)
    pix = xy.reshape(b, 2, h, w).permute(0, 2, 3, 1)
    sx = pix[..., 0] / (w - 1)
    sy = pix[..., 1] / (h - 1)
    return torch.stack([(sx - 0.5) * 2.0, (sy - 0.5) * 2.0], dim=-1)


def inverse_rotation_warp(img, rot, intrinsics, padding_mode: str = "zeros",
                          use_kernel: bool = False):
    """Re-render img [B,H,W,C] as seen after the rotation rot [B,3] (Euler
    angles) about the camera centre, intrinsics [B,3,3]; the RectifyNet
    warp (reference layers.py:460-479), align_corners=True."""
    _, h, w, _ = img.shape
    coords = rotation_grid(rot, intrinsics, h, w, img.dtype)
    return grid_sample(img, coords, padding_mode, align_corners=True, use_kernel=use_kernel)
