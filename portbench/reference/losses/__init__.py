"""Training losses (port of ``scflow_tpu/losses/__init__.py``): sequence
weighting, the RAFT flow L1, the mask L1 and (disentangled) point
matching. Per-class mesh points come from a (C, P, 3) points bank with
validity masks; symmetric classes match each target point to its nearest
predicted point. Functions are batched over samples, and the sequence
losses loop over the (T, ...) iteration axis as the JAX ``vmap`` maps it.
"""
from __future__ import annotations

import torch

from ..geometry.se3 import matvec3, transform_points

_EPS = 1e-10


def sequence_loss(per_iter_loss: torch.Tensor, gamma: float = 0.8):
    """(Σ_i gamma^(T−1−i)·loss_i, per_iter_loss) of a (T,) loss vector."""
    t = per_iter_loss.shape[0]
    weights = gamma ** torch.arange(t - 1, -1, -1, dtype=per_iter_loss.dtype,
                                    device=per_iter_loss.device)
    return (weights * per_iter_loss).sum(), per_iter_loss


def _norm(v: torch.Tensor, ord_: int) -> torch.Tensor:
    """Vector norm over the last axis as ``jnp.linalg.norm`` computes it."""
    if ord_ == 1:
        return v.abs().sum(-1)
    return v.square().sum(-1).sqrt()


def raft_flow_loss(pred_flow: torch.Tensor, gt_flow: torch.Tensor,
                   valid: torch.Tensor | None = None, max_flow: float = 400.0,
                   sample_weight: torch.Tensor | None = None) -> torch.Tensor:
    """Masked L1 flow loss over (N, H, W, 2) flows: pixels whose GT flow is
    shorter than ``max_flow`` and, if given, ``valid`` (N, H, W) ≥ 0.5;
    ``sample_weight`` (N,) weights whole samples (padded slots 0)."""
    v = _norm(gt_flow, 2) < max_flow
    if valid is not None:
        v = v & (valid >= 0.5)
    v = v.to(gt_flow.dtype)
    if sample_weight is not None:
        v = v * sample_weight.to(v.dtype)[:, None, None]
    l1 = (pred_flow - gt_flow).abs()
    return (v[..., None] * l1).sum() / (v.sum() + _EPS)


def mask_l1_loss(pred_mask: torch.Tensor, gt_mask: torch.Tensor,
                 sample_weight: torch.Tensor | None = None) -> torch.Tensor:
    """Mean L1 over (N, H, W); with ``sample_weight`` (N,) the weighted
    mean of the per-sample means."""
    if sample_weight is None:
        return (pred_mask - gt_mask).abs().mean()
    w = sample_weight.to(pred_mask.dtype)
    per_sample = (pred_mask - gt_mask).abs().mean(dim=(-2, -1))
    return (per_sample * w).sum() / (w.sum() + _EPS)


def _nearest_match(target: torch.Tensor, pred: torch.Tensor,
                   point_valid: torch.Tensor) -> torch.Tensor:
    """For each target point (N, P, 3), the nearest valid pred point
    (N, P, 3): dense squared distances |t|² + |p|² − 2 t·p, argmin. The
    argmin carries no gradient, so the distances are built without one."""
    with torch.no_grad():
        cross = (target[:, :, None, :] * pred[:, None, :, :]).sum(-1)
        d2 = (target.square().sum(-1)[:, :, None]
              + pred.square().sum(-1)[:, None, :] - 2.0 * cross)
        d2 = torch.where(point_valid[:, None, :], d2, torch.inf)
        idx = d2.argmin(dim=-1)                                 # (N, P)
    return pred.gather(1, idx[..., None].expand(-1, -1, 3))


def point_matching_loss(pred_r, pred_t, gt_r, gt_t, points, point_valid,
                        symmetric, diameters, loss_type: str = "l2"):
    """ADD-style pose loss, (N,) per sample, normalised by the diameter.

    pred_r/gt_r (N, 3, 3), pred_t/gt_t (N, 3), points (N, P, 3) gathered by
    label, point_valid (N, P), symmetric (N,) bool, diameters (N,)."""
    ord_ = 1 if loss_type == "l1" else 2
    pred = transform_points(pred_r, pred_t, points)
    target = transform_points(gt_r, gt_t, points)
    matched = _nearest_match(target, pred, point_valid)
    pred_use = torch.where(symmetric[:, None, None], matched, pred)
    dist = _norm(pred_use - target, ord_)
    w = point_valid.to(dist.dtype)
    mean = (dist * w).sum(-1) / w.sum(-1).clamp_min(1.0)
    return mean / diameters


def disentangled_point_matching_loss(pred_r, pred_t, gt_r, gt_t, points,
                                     point_valid, symmetric, diameters,
                                     loss_type: str = "l1",
                                     disentangle_z: bool = True):
    """GDR-Net-style disentangled point matching, (N,) per sample: a
    rotation term (pred rotation, GT translation, symmetric matching) and
    translation terms (xy and z apart with ``disentangle_z``), each against
    the GT-posed points."""
    ord_ = 1 if loss_type == "l1" else 2
    w = point_valid.to(points.dtype)
    wsum = w.sum(-1).clamp_min(1.0)

    def wmean(d):
        return (d * w).sum(-1) / wsum

    pts_gt_rot = matvec3(gt_r[:, None], points)
    pts_gt_rt = pts_gt_rot + gt_t[:, None, :]
    pts_pred_rot = matvec3(pred_r[:, None], points) + gt_t[:, None, :]
    matched = _nearest_match(pts_gt_rt, pts_pred_rot, point_valid)
    pts_pred_rot = torch.where(symmetric[:, None, None], matched, pts_pred_rot)
    loss_rot = wmean(_norm(pts_pred_rot - pts_gt_rt, ord_))

    if disentangle_z:
        t_z = torch.cat([gt_t[:, :2], pred_t[:, 2:]], dim=-1)
        loss_z = wmean(_norm(pts_gt_rot + t_z[:, None, :] - pts_gt_rt, ord_))
        t_xy = torch.cat([pred_t[:, :2], gt_t[:, 2:]], dim=-1)
        loss_xy = wmean(_norm(pts_gt_rot + t_xy[:, None, :] - pts_gt_rt, ord_))
        loss_trans = loss_z + loss_xy
    else:
        loss_trans = wmean(_norm(pts_gt_rot + pred_t[:, None, :] - pts_gt_rt,
                                 ord_))
    return (loss_rot + loss_trans) / diameters


def rot_point_matching_loss(pred_r, gt_r, points, point_valid, symmetric,
                            diameters, loss_type: str = "l1"):
    """Rotation-only point matching, (N,) per sample, normalised by the
    diameter: the points rotated by the predicted and the GT rotation, no
    translation; symmetric classes matched to the nearest point
    (reference RotPointMatchingLoss, point_matching_loss.py:222-291)."""
    ord_ = 1 if loss_type == "l1" else 2
    pred = matvec3(pred_r[:, None], points)
    target = matvec3(gt_r[:, None], points)
    matched = _nearest_match(target, pred, point_valid)
    pred_use = torch.where(symmetric[:, None, None], matched, pred)
    dist = _norm(pred_use - target, ord_)
    w = point_valid.to(dist.dtype)
    mean = (dist * w).sum(-1) / w.sum(-1).clamp_min(1.0)
    return mean / diameters


def _batch_mean(per_sample: torch.Tensor, sample_weight) -> torch.Tensor:
    if sample_weight is None:
        return per_sample.mean()
    w = sample_weight.to(per_sample.dtype)
    return (per_sample * w).sum() / (w.sum() + _EPS)


def sequence_pose_loss(seq_r, seq_t, gt_r, gt_t, points, point_valid,
                       symmetric, diameters, gamma: float = 0.8,
                       loss_weight: float = 10.0, loss_type: str = "l1",
                       disentangled: bool = True, disentangle_z: bool = True,
                       sample_weight=None):
    """Sequence-weighted pose loss over (T, N, ...) poses; with
    ``sample_weight`` (N,) each iteration's batch mean is weighted.
    Returns (weight·total, weight·per-iteration losses)."""
    losses = []
    for r, t in zip(seq_r, seq_t):
        if disentangled:
            per = disentangled_point_matching_loss(
                r, t, gt_r, gt_t, points, point_valid, symmetric, diameters,
                loss_type=loss_type, disentangle_z=disentangle_z)
        else:
            per = point_matching_loss(r, t, gt_r, gt_t, points, point_valid,
                                      symmetric, diameters,
                                      loss_type=loss_type)
        losses.append(_batch_mean(per, sample_weight))
    total, per_iter = sequence_loss(torch.stack(losses), gamma)
    return loss_weight * total, loss_weight * per_iter


def sequence_flow_loss(seq_flow, gt_flow, valid, gamma: float = 0.8,
                       loss_weight: float = 0.1, max_flow: float = 400.0,
                       sample_weight=None):
    """Sequence-weighted RAFT flow loss over (T, N, H, W, 2) flows."""
    losses = torch.stack([raft_flow_loss(f, gt_flow, valid, max_flow,
                                         sample_weight) for f in seq_flow])
    total, per_iter = sequence_loss(losses, gamma)
    return loss_weight * total, loss_weight * per_iter


def sequence_mask_loss(seq_mask, gt_mask, gamma: float = 0.8,
                       loss_weight: float = 10.0, sample_weight=None):
    """Sequence-weighted mask L1 over (T, N, H, W) masks."""
    losses = torch.stack([mask_l1_loss(m, gt_mask, sample_weight)
                          for m in seq_mask])
    total, per_iter = sequence_loss(losses, gamma)
    return loss_weight * total, loss_weight * per_iter
