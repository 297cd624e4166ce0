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


def coords_from_flow(flow: torch.Tensor) -> torch.Tensor:
    """Absolute target coordinates (..., H, W, 2): the pixel grid plus the
    flow (reference flow.py:90-103)."""
    h, w = flow.shape[-3:-1]
    return pixel_grid(h, w, flow.dtype, flow.device) + flow


def _landing_index(flow: torch.Tensor) -> torch.Tensor:
    """Flat index (..., H·W) of the pixel each flow vector lands on: the
    nearest by ``round`` (half to even), clipped to the frame."""
    h, w = flow.shape[-3:-1]
    target = coords_from_flow(flow)
    tx = torch.round(target[..., 0]).long().clamp(0, w - 1)
    ty = torch.round(target[..., 1]).long().clamp(0, h - 1)
    return (ty * w + tx).reshape(ty.shape[:-2] + (h * w,))


def _gather_landed(image: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    h, w = image.shape[-2:]
    flat = image.reshape(image.shape[:-2] + (h * w,))
    return flat.gather(-1, idx).reshape(image.shape)


def filter_flow_by_depth(flow: torch.Tensor, depth_src: torch.Tensor,
                         depth_target: torch.Tensor, k: torch.Tensor,
                         rotation_src: torch.Tensor,
                         translation_src: torch.Tensor,
                         rotation_target: torch.Tensor,
                         translation_target: torch.Tensor,
                         consistency_thr: float = 0.05,
                         invalid_num: float = DEFAULT_INVALID_FLOW
                         ) -> torch.Tensor:
    """Keep a flow vector (..., H, W, 2) only where the source pixel's
    object point, moved into the target camera, has a depth within
    ``consistency_thr`` (relative) of the target render's depth at the
    landing pixel (reference models/utils/flow.py:28-45); depths
    (..., H, W), k (..., 3, 3), poses (..., 3, 3) and (..., 3)."""
    _, pts_obj = unproject_depth(depth_src, k, rotation_src, translation_src)
    z_in_target = ((rotation_target[..., None, None, 2, :] * pts_obj).sum(-1)
                   + translation_target[..., 2][..., None, None])
    sampled = _gather_landed(depth_target, _landing_index(flow))
    rel_err = (sampled - z_in_target).abs() / z_in_target.clamp_min(1e-6)
    ok = (depth_src > 0) & (sampled > 0) & (rel_err < consistency_thr)
    return torch.where(ok[..., None], flow, invalid_num)


def filter_flow_by_face_index(flow: torch.Tensor, face_id_src: torch.Tensor,
                              face_id_target: torch.Tensor,
                              invalid_num: float = DEFAULT_INVALID_FLOW
                              ) -> torch.Tensor:
    """Keep flow only where the source and the landing pixel see the same
    mesh face (reference models/utils/flow.py:47-59); face ids (..., H, W)
    integers, -1 for background."""
    landed = _gather_landed(face_id_target, _landing_index(flow))
    ok = (face_id_src >= 0) & (landed == face_id_src)
    return torch.where(ok[..., None], flow, invalid_num)
