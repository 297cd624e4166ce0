"""Delta-pose composition and rigid transforms (port of
``scflow_tpu/geometry/se3.py:19-73``)."""
from __future__ import annotations

import torch

from .rotation import ortho6d_to_matrix, quaternion_to_matrix


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as an elementwise f32 sum (no TF32 path)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def matvec3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) as an elementwise f32 sum; broadcasts."""
    return (m * v[..., None, :]).sum(-1)


def transform_points(rotation: torch.Tensor, translation: torch.Tensor,
                     points: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., P, 3) + (..., 3) → (..., P, 3)."""
    return (matvec3(rotation[..., None, :, :], points)
            + translation[..., None, :])


def compose_delta_pose(rotation_delta: torch.Tensor,
                       translation_delta: torch.Tensor,
                       rotation_src: torch.Tensor,
                       translation_src: torch.Tensor,
                       weight: float = 10.0,
                       depth_transform: str = "exp",
                       detach_depth_for_xy: bool = False):
    """Compose a predicted delta pose onto the source pose.

    R_dst = R_delta @ R_src; the translation update lives in screen space:
    vz = tz / exp(dz) ('exp') or tz · (dz + 1); vx = vz · (dx / weight +
    tx / tz), likewise vy. ``detach_depth_for_xy`` detaches vz inside vx, vy.
    Returns (R_dst (N, 3, 3), t_dst (N, 3)).
    """
    if rotation_delta.shape[-1] == 4:
        r_delta = quaternion_to_matrix(rotation_delta)
    elif rotation_delta.shape[-1] == 6:
        r_delta = ortho6d_to_matrix(rotation_delta)
    else:
        raise ValueError("rotation_delta must be (..., 4) or (..., 6), got "
                         f"{tuple(rotation_delta.shape)}")
    rotation_dst = matmul3(r_delta, rotation_src)
    tx, ty, tz = translation_src.unbind(-1)
    dx, dy, dz = translation_delta.unbind(-1)
    vz = tz / torch.exp(dz) if depth_transform == "exp" else tz * (dz + 1.0)
    vz_xy = vz.detach() if detach_depth_for_xy else vz
    vx = vz_xy * (dx / weight + tx / tz)
    vy = vz_xy * (dy / weight + ty / tz)
    return rotation_dst, torch.stack([vx, vy, vz], dim=-1)
