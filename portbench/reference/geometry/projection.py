"""Pinhole projection on dense grids (port of
``scflow_tpu/geometry/projection.py:17-99``). JAX layout: (..., H, W, C).
All 3×3 products are elementwise f32 sums (see ``se3.matvec3``)."""
from __future__ import annotations

import torch

from .se3 import matvec3


def project_points(points_3d: torch.Tensor, k: torch.Tensor,
                   rotation: torch.Tensor, translation: torch.Tensor,
                   eps: float = 1e-8):
    """(..., P, 3) object-frame points → (xy (..., P, 2), z (..., P))."""
    p_cam = matvec3(rotation[..., None, :, :], points_3d) + translation[..., None, :]
    uvw = matvec3(k[..., None, :, :], p_cam)
    z = uvw[..., 2]
    return uvw[..., :2] / (z[..., None] + eps), z


def pixel_grid(height: int, width: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """(H, W, 2) grid of pixel-center coordinates in xy order."""
    ys, xs = torch.meshgrid(torch.arange(height, dtype=dtype, device=device),
                            torch.arange(width, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)


def inverse3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate / determinant) inverse of (..., 3, 3) matrices."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co0, co1, co2 = e * i - f * h, f * g - d * i, d * h - e * g
    det = a * co0 + b * co1 + c * co2
    adj = torch.stack([
        co0, c * h - b * i, b * f - c * e,
        co1, a * i - c * g, c * d - a * f,
        co2, b * g - a * h, a * e - b * d,
    ], dim=-1).reshape(m.shape)
    return adj / det[..., None, None]


def unproject_depth(depth: torch.Tensor, k: torch.Tensor,
                    rotation: torch.Tensor | None = None,
                    translation: torch.Tensor | None = None):
    """Lift (..., H, W) z-depth to camera-frame points (..., H, W, 3) and,
    given a pose, object-frame points. Background (depth <= 0) gives zeros."""
    h, w = depth.shape[-2:]
    grid = pixel_grid(h, w, depth.dtype, depth.device)
    homo = torch.cat([grid, torch.ones_like(grid[..., :1])], dim=-1)
    rays = matvec3(inverse3(k)[..., None, None, :, :], homo)
    valid = (depth > 0)[..., None]
    pts_cam = torch.where(valid, rays * depth[..., None], 0.0)
    if rotation is None:
        return pts_cam
    r_inv = rotation.transpose(-1, -2)[..., None, None, :, :]
    pts_obj = matvec3(r_inv, pts_cam - translation[..., None, None, :])
    return pts_cam, torch.where(valid, pts_obj, 0.0)


def depth_to_correspondences(depth: torch.Tensor, k: torch.Tensor,
                             rotation: torch.Tensor, translation: torch.Tensor):
    """Dense (points_2d (..., H, W, 2), points_3d (..., H, W, 3), valid
    (..., H, W)) correspondence grids from a rendered depth map."""
    _, pts_obj = unproject_depth(depth, k, rotation, translation)
    h, w = depth.shape[-2:]
    pts_2d = pixel_grid(h, w, depth.dtype, depth.device).expand(
        depth.shape[:-2] + (h, w, 2))
    return pts_2d, pts_obj, depth > 0


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor, *,
                    padding_zero: bool = True) -> torch.Tensor:
    """Bilinearly sample ``img`` (..., C, H, W) at pixel coordinates
    ``coords`` (..., P, 2) in xy order → (..., C, P).

    Pixel centres at integer coordinates (grid_sample's align_corners=True,
    reference models/utils/corr_lookup.py:31-67). A tap outside the frame
    reads 0 with ``padding_zero``, else the nearest edge pixel."""
    h, w = img.shape[-2:]
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None, :], (y - y0)[..., None, :]
    x0i, y0i = x0.long(), y0.long()
    flat = img.reshape(img.shape[:-2] + (h * w,))

    def tap(yi, xi):
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        val = flat.gather(-1, idx[..., None, :].expand(
            idx.shape[:-1] + (flat.shape[-2], idx.shape[-1])))
        if padding_zero:
            inb = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
            val = torch.where(inb[..., None, :], val, 0.0)
        return val

    v00, v01 = tap(y0i, x0i), tap(y0i, x0i + 1)
    v10, v11 = tap(y0i + 1, x0i), tap(y0i + 1, x0i + 1)
    return ((1 - wy) * ((1 - wx) * v00 + wx * v01)
            + wy * ((1 - wx) * v10 + wx * v11))
