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


def ortho6d_to_matrix(ortho6d: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt a (..., 6) rotation rep into (..., 3, 3); columns x, y, z."""
    x = normalize(ortho6d[..., 0:3])
    z = normalize(torch.linalg.cross(x, ortho6d[..., 3:6], dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)
