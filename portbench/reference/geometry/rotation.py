"""Rotation parameterizations (port of ``scflow_tpu/geometry/rotation.py``).

Quaternions are (x, y, z, w); matrices act on column vectors. Everything
is elementwise f32 arithmetic: no matmul, so TF32 settings cannot reach it.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def normalize(v: torch.Tensor, dim: int = -1, eps: float = _EPS) -> torch.Tensor:
    """L2-normalize along ``dim`` with a numerical floor."""
    n = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    return v / n.clamp_min(eps)


def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyzw quaternions → (..., 3, 3) rotation matrices."""
    quat = normalize(quat)
    x, y, z, w = quat.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], dim=-1)
    return m.reshape(quat.shape[:-1] + (3, 3))


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices → (..., 4) xyzw quaternions.

    Branch-free Shepperd's method: all four candidate constructions, one
    per pivot (w, x, y, z), and the one of the largest pivot taken (the
    first on a tie, as ``argmax``), then normalised."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    cands = torch.stack([
        torch.stack([m21 - m12, m02 - m20, m10 - m01, pivots[..., 0]], -1),
        torch.stack([pivots[..., 1], m01 + m10, m02 + m20, m21 - m12], -1),
        torch.stack([m01 + m10, pivots[..., 2], m12 + m21, m02 - m20], -1),
        torch.stack([m02 + m20, m12 + m21, pivots[..., 3], m10 - m01], -1),
    ], -2) / (2.0 * torch.sqrt(pivots.clamp_min(_EPS)))[..., None]
    choice = pivots.argmax(-1)
    q = cands.gather(-2, choice[..., None, None].expand(
        choice.shape + (1, 4)))[..., 0, :]
    return normalize(q)


def ortho6d_to_matrix(ortho6d: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt a (..., 6) rotation rep into (..., 3, 3); columns x, y, z."""
    x = normalize(ortho6d[..., 0:3])
    z = normalize(torch.linalg.cross(x, ortho6d[..., 3:6], dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula for (..., 3) axis-angle vectors → (..., 3, 3);
    angle 0 gives the identity."""
    angle = torch.linalg.vector_norm(axis_angle, dim=-1, keepdim=True)
    axis = axis_angle / angle.clamp_min(_EPS)
    x, y, z = axis.unbind(-1)
    c = torch.cos(angle)[..., 0]
    s = torch.sin(angle)[..., 0]
    C = 1.0 - c
    m = torch.stack([
        x * x * C + c, x * y * C - z * s, x * z * C + y * s,
        y * x * C + z * s, y * y * C + c, y * z * C - x * s,
        z * x * C - y * s, z * y * C + x * s, z * z * C + c,
    ], dim=-1).reshape(axis_angle.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=m.dtype, device=m.device).expand(m.shape)
    return torch.where(angle[..., None] < _EPS, eye, m)


def matrix_to_ortho6d(m: torch.Tensor) -> torch.Tensor:
    """The first two columns of (..., 3, 3), flattened to (..., 6)."""
    return torch.cat([m[..., :, 0], m[..., :, 1]], dim=-1)


def matrix_to_axis_angle(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices → (..., 3) axis-angle vectors (the
    angle in [0, π], through :func:`matrix_to_quaternion`)."""
    q = matrix_to_quaternion(m)
    xyz, w = q[..., :3], q[..., 3]
    n = torch.linalg.vector_norm(xyz, dim=-1)
    angle = 2.0 * torch.atan2(n, w.abs())
    sign = torch.where(w < 0, -1.0, 1.0)
    return xyz * (sign / n.clamp_min(_EPS) * angle)[..., None]


def rotation_angle_deg(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle in degrees between two batches of rotation matrices
    (reference datasets/pose.py:106-112)."""
    rel = (r1[..., :, :, None] * r2.transpose(-1, -2)[..., None, :, :]).sum(-2)
    cos = 0.5 * (rel.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0)
    return torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0)))


def random_rotation(generator: torch.Generator,
                    batch_shape: tuple = ()) -> torch.Tensor:
    """Uniformly random rotation matrices (normalised Gaussian quaternions),
    drawn on the generator's device."""
    q = torch.randn(tuple(batch_shape) + (4,), generator=generator,
                    device=generator.device)
    return quaternion_to_matrix(normalize(q))
