"""Pose-induced flow, the GT-flow mask filter and the endpoint error (port
of ``scflow_tpu/geometry/flow.py:31-205``). Flow is (..., H, W, 2) in xy
order, the JAX layout."""
from __future__ import annotations

import torch

from .projection import pixel_grid, unproject_depth
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


def flow_from_pose_and_depth(rotation_src: torch.Tensor,
                             translation_src: torch.Tensor,
                             rotation_dst: torch.Tensor,
                             translation_dst: torch.Tensor,
                             depth_src: torch.Tensor, k: torch.Tensor,
                             invalid_num: float = DEFAULT_INVALID_FLOW
                             ) -> torch.Tensor:
    """Flow from the source render (pose_src, depth_src) to the target
    pose: the GT flow of training."""
    _, pts_obj = unproject_depth(depth_src, k, rotation_src, translation_src)
    return flow_from_pose_and_points(rotation_dst, translation_dst, k,
                                     pts_obj, depth_src > 0, invalid_num)


def _grid_sample_zeros(image: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (..., H, W) at pixel coords (x, y) of shape
    (..., H', W') with zero padding, the four taps gathered and summed in
    the JAX package's order."""
    h, w = image.shape[-2:]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    flat = image.reshape(image.shape[:-2] + (h * w,)).to(x.dtype)

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        v = flat.gather(-1, idx.reshape(idx.shape[:-2] + (-1,)))
        return torch.where(inb, v.reshape(idx.shape), 0.0)

    return (tap(x0i, y0i) * (1 - wx) * (1 - wy)
            + tap(x0i + 1, y0i) * wx * (1 - wy)
            + tap(x0i, y0i + 1) * (1 - wx) * wy
            + tap(x0i + 1, y0i + 1) * wx * wy)


def filter_flow_by_mask(flow: torch.Tensor, target_mask: torch.Tensor,
                        invalid_num: float = DEFAULT_INVALID_FLOW,
                        threshold: float = 0.9) -> torch.Tensor:
    """Invalidate flow whose target lands outside the target-image mask.

    A flow vector from source pixel p is kept only if ``target_mask``
    (..., H, W), bilinearly sampled with zero padding at
    (p + flow)·W/(W − 1) − 0.5, is at least ``threshold``. The half-pixel
    shift is mmflow's quirk (grid_sample, align_corners=False, on a grid
    normalised by W − 1), kept so GT supervision matches the reference's.
    """
    h, w = target_mask.shape[-2:]
    target = pixel_grid(h, w, flow.dtype, flow.device) + flow
    sx = target[..., 0] * (w / max(w - 1, 1)) - 0.5
    sy = target[..., 1] * (h / max(h - 1, 1)) - 0.5
    sampled = _grid_sample_zeros(target_mask.to(flow.dtype), sx, sy)
    return torch.where((sampled >= threshold)[..., None], flow, invalid_num)


def endpoint_error(flow_pred: torch.Tensor, flow_gt: torch.Tensor,
                   valid: torch.Tensor | None = None) -> dict:
    """Mean EPE and the 1/3/5-px accuracies over the valid pixels
    (``valid`` bool, or float kept where > 0.5): dict(epe, acc1, acc3,
    acc5) of 0-d tensors (reference models/utils/flow.py:64-88)."""
    err = torch.linalg.vector_norm(flow_pred - flow_gt, dim=-1)
    if valid is None:
        valid = torch.ones_like(err, dtype=torch.bool)
    elif valid.dtype != torch.bool:
        valid = valid > 0.5
    n = valid.sum().clamp_min(1)

    def mean(x):
        return torch.where(valid, x, 0.0).sum() / n

    return {"epe": mean(err), "acc1": mean((err < 1.0).to(err.dtype)),
            "acc3": mean((err < 3.0).to(err.dtype)),
            "acc5": mean((err < 5.0).to(err.dtype))}
