"""Camera geometry. Counterpart of ``sfmnext_tpu/ops/geometry.py``
(``disp_to_depth``, ``rot_from_axisangle`` .. ``project_depth`` and
``euler_to_mat``, reference layers.py:51-258, 422-457).

Pixel-coordinate math stays float32: the JAX package asks for
``Precision.HIGHEST`` on every product here, and the port's entry points
turn TF32 off (``device.disable_tf32``), so a float32 matmul on the card
is a float32 matmul. Callers keep these functions outside autocast.
Layouts are the JAX package's: depth ``[B,H,W,1]``, points ``[B,4,H*W]``,
normalised pixel coordinates ``[B,H,W,2]`` in (x, y) order.
"""

from __future__ import annotations

import torch


def _transform(mat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """mat [B,I,J] applied to points [B,J,N] -> [B,I,N], as J broadcast
    multiply-adds. As an einsum, its backward to ``mat`` is a batched GEMM
    with an N-long reduction, which cuBLAS ran one block a sample: 3.3 ms
    a call at B=8, N=320*1024 (NVIDIA H100 80GB HBM3, 700 W;
    ``chip_smoke.py --profile``). Here the backward is PyTorch's
    elementwise product and reduction instead."""
    return (mat[..., None] * points[:, None]).sum(dim=2)


def disp_to_depth(disp, min_depth: float, max_depth: float):
    """Sigmoid disparity -> (scaled_disp, depth), numpy or torch.
    Reference layers.py:51-60."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    depth = 1.0 / scaled_disp
    return scaled_disp, depth


def rot_from_axisangle(vec: torch.Tensor) -> torch.Tensor:
    """Axis-angle [B,3] -> homogeneous rotation [B,4,4] (Rodrigues)."""
    angle = torch.linalg.norm(vec, dim=-1, keepdim=True)  # [B,1]
    axis = vec / (angle + 1e-7)
    ca = torch.cos(angle)[..., 0]
    sa = torch.sin(angle)[..., 0]
    c = 1.0 - ca
    x, y, z = axis.unbind(-1)
    xs, ys, zs = x * sa, y * sa, z * sa
    xc, yc, zc = x * c, y * c, z * c
    xyc, yzc, zxc = x * yc, y * zc, z * xc
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    rot = torch.stack([
        x * xc + ca, xyc - zs, zxc + ys, zeros,
        xyc + zs, y * yc + ca, yzc - xs, zeros,
        zxc - ys, yzc + xs, z * zc + ca, zeros,
        zeros, zeros, zeros, ones,
    ], dim=-1)
    return rot.reshape(vec.shape[0], 4, 4)


def get_translation_matrix(t: torch.Tensor) -> torch.Tensor:
    """Translation [B,3] -> homogeneous [B,4,4]."""
    b = t.shape[0]
    eye = torch.eye(4, dtype=t.dtype, device=t.device).expand(b, 4, 4)
    col = torch.cat([t, torch.ones_like(t[:, :1])], dim=1)  # [B,4]
    return torch.cat([eye[:, :, :3], col[:, :, None]], dim=2)


def transformation_from_parameters(axisangle, translation, invert: bool = False):
    """(axis-angle [B,3], translation [B,3]) -> SE(3) [B,4,4]; with
    ``invert`` R^T after the negated translation (past frames)."""
    rot = rot_from_axisangle(axisangle)
    t = translation
    if invert:
        rot = rot.transpose(1, 2)
        t = -t
    trans = get_translation_matrix(t)
    return torch.matmul(rot, trans) if invert else torch.matmul(trans, rot)


def pixel_grid(height: int, width: int, dtype=torch.float32, device=None):
    """Homogeneous pixel coordinates [3, H*W] in (x, y, 1) order."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=dtype, device=device),
        torch.arange(width, dtype=dtype, device=device), indexing="ij",
    )
    ones = torch.ones(height * width, dtype=dtype, device=device)
    return torch.stack([xs.reshape(-1), ys.reshape(-1), ones], dim=0)


def backproject_depth(depth: torch.Tensor, inv_K: torch.Tensor) -> torch.Tensor:
    """Depth [B,H,W,1] (or [B,H,W]) + inverse intrinsics [B,4,4] ->
    homogeneous camera points [B,4,H*W]."""
    if depth.dim() == 4:
        depth = depth[..., 0]
    b, h, w = depth.shape
    grid = pixel_grid(h, w, depth.dtype, depth.device)
    rays = torch.einsum("bij,jn->bin", inv_K[:, :3, :3], grid)
    pts = depth.reshape(b, 1, h * w) * rays
    return torch.cat([pts, torch.ones_like(pts[:, :1])], dim=1)


def project_3d(points, K, T, height: int, width: int, eps: float = 1e-7):
    """Points [B,4,H*W] into the camera K [B,4,4] after T [B,4,4] ->
    normalised pixel coordinates [B,H,W,2] in [-1,1] (grid_sample's)."""
    proj = torch.matmul(K, T)[:, :3, :]
    cam = _transform(proj, points)  # [B,3,HW]
    xy = cam[:, :2] / (cam[:, 2:3] + eps)
    pix = xy.reshape(points.shape[0], 2, height, width).permute(0, 2, 3, 1)
    sx = pix[..., 0] / (width - 1)
    sy = pix[..., 1] / (height - 1)
    return torch.stack([(sx - 0.5) * 2.0, (sy - 0.5) * 2.0], dim=-1)


def project_depth(points, K, T, height: int, width: int):
    """The depth (z) of points [B,4,H*W] in the camera K [B,4,4] after T
    [B,4,4] -> [B,H,W,1] (reference layers.py:228-234)."""
    proj = torch.matmul(K, T)[:, 2:3, :]  # only the z row is read
    return _transform(proj, points).reshape(points.shape[0], height, width, 1)


def euler_to_mat(angle: torch.Tensor) -> torch.Tensor:
    """Euler angles [B,3] (x, y, z) -> rotation [B,3,3] = Rx @ Ry @ Rz
    (reference layers.py:422-457)."""
    x, y, z = angle.unbind(-1)
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    cx, sx = torch.cos(x), torch.sin(x)
    zeros, ones = torch.zeros_like(z), torch.ones_like(z)

    def mat(*entries):
        return torch.stack(entries, dim=1).reshape(-1, 3, 3)

    zmat = mat(cz, -sz, zeros, sz, cz, zeros, zeros, zeros, ones)
    ymat = mat(cy, zeros, sy, zeros, ones, zeros, -sy, zeros, cy)
    xmat = mat(ones, zeros, zeros, zeros, cx, -sx, zeros, sx, cx)
    return torch.matmul(torch.matmul(xmat, ymat), zmat)
