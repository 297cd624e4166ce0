"""Pose-induced flow (port of ``scflow_tpu/geometry/flow.py:31-60``)."""
from __future__ import annotations

import torch

from .projection import pixel_grid
from .se3 import matvec3

DEFAULT_INVALID_FLOW = 400.0


def flow_from_pose_and_points(rotation_dst: torch.Tensor,
                              translation_dst: torch.Tensor, k: torch.Tensor,
                              points_3d: torch.Tensor, valid: torch.Tensor,
                              invalid_num: float = DEFAULT_INVALID_FLOW,
                              eps: float = 1e-8) -> torch.Tensor:
    """Flow (..., H, W, 2) that moves each valid source pixel to the
    projection of its object-frame point under the destination pose;
    invalid pixels carry ``invalid_num``."""
    h, w = valid.shape[-2:]
    p_cam = (matvec3(rotation_dst[..., None, None, :, :], points_3d)
             + translation_dst[..., None, None, :])
    uvw = matvec3(k[..., None, None, :, :], p_cam)
    xy_dst = uvw[..., :2] / (uvw[..., 2:3] + eps)
    flow = xy_dst - pixel_grid(h, w, xy_dst.dtype, xy_dst.device)
    return torch.where(valid[..., None], flow, invalid_num)
