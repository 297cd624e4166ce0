"""Delta-pose composition, rigid transforms and the ADD / ADD-S pose
errors (port of ``scflow_tpu/geometry/se3.py:19-132``). Every product is
an elementwise f32 sum, so no TF32 path reaches the pose math."""
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


def add_error(r_pred: torch.Tensor, t_pred: torch.Tensor, r_gt: torch.Tensor,
              t_gt: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """ADD: the mean distance between the mesh points (N, P, 3), or (P, 3)
    broadcast over the batch, under the predicted and the GT pose → (N,)
    (reference metrics/add.py, the non-symmetric branch)."""
    diff = (transform_points(r_pred, t_pred, points)
            - transform_points(r_gt, t_gt, points))
    return torch.linalg.vector_norm(diff, dim=-1).mean(-1)


def adds_error(r_pred: torch.Tensor, t_pred: torch.Tensor, r_gt: torch.Tensor,
               t_gt: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """ADD-S: for each GT-posed point the distance to the nearest
    pred-posed point, averaged → (N,) (reference metrics/add.py:386-394).

    The JAX package's dense form |a|² + |b|² − 2a·b over all (P, P) pairs,
    clamped at 0, with the cross products summed elementwise in f32 (a
    (…, P, P, 3) intermediate). Near zero distance it cancels: its f32
    rounding scale is ~2⁻²³·(|a|² + |b|²), ~0.09 mm² at 600 mm."""
    p_pred = transform_points(r_pred, t_pred, points)      # (..., P, 3)
    p_gt = transform_points(r_gt, t_gt, points)
    sq_pred = (p_pred * p_pred).sum(-1)
    sq_gt = (p_gt * p_gt).sum(-1)
    cross = (p_gt[..., :, None, :] * p_pred[..., None, :, :]).sum(-1)
    d2 = sq_gt[..., :, None] + sq_pred[..., None, :] - 2.0 * cross
    return d2.clamp_min(0.0).amin(-1).sqrt().mean(-1)
