"""Flow → pose for the RAFT refiner family: test-time RANSAC-EPnP (port of
``scflow_tpu/models/flow_pose.py``).

2D-3D correspondences come from the predicted flow and the rendered depth
at the reference pose, filtered by the occlusion confidence, subsampled to
a fixed budget by Gumbel top-k, and solved per sample by
``geometry.pnp.ransac_pnp_core``; a sample falls back to its reference pose
where too few points are valid, the result is not finite or fewer than 4
points are inliers. Fixed shapes throughout (weights mark the points).

The draws are apart from the deterministic core: :func:`gumbel_draws`
makes them from a ``torch.Generator`` and :func:`solve_pose_from_flow_core`
takes them, so draws of another source (the JAX package's keys, in the
tests) can be fed in.
"""
from __future__ import annotations

import torch

from ..geometry.pnp import gumbel, ransac_pnp_core, top_k_indices
from ..geometry.projection import depth_to_correspondences, pixel_grid


def gumbel_draws(generator: torch.Generator, n: int, pixels: int,
                 max_points: int = 1024, num_hypotheses: int = 64):
    """(subsample noise (n, pixels), hypothesis noise (n, num_hypotheses,
    max_points)) drawn on the generator's device, subsample first."""
    return (gumbel(generator, (n, pixels)),
            gumbel(generator, (n, num_hypotheses, max_points)))


def solve_pose_from_flow_core(subsample_noise: torch.Tensor,
                              hypothesis_noise: torch.Tensor,
                              flow: torch.Tensor,
                              occlusion: torch.Tensor | None,
                              depth: torch.Tensor,
                              ref_rotations: torch.Tensor,
                              ref_translations: torch.Tensor,
                              k: torch.Tensor,
                              occlusion_threshold: float = 0.5,
                              inlier_threshold: float = 3.0,
                              min_valid_points: int = 16) -> dict:
    """Batched flow→pose on given Gumbel noise.

    flow (N, H, W, 2) forward flow (render → real); occlusion (N, H, W)
    visibility confidence in [0, 1] or None for no filter; depth (N, H, W)
    rendered at the reference pose (N, 3, 3)/(N, 3); k (N, 3, 3).
    ``subsample_noise`` (N, H·W) picks the max_points = P valid pixels of
    largest noise (invalid pixels score −inf and carry weight 0);
    ``hypothesis_noise`` (N, hypotheses, P) seeds RANSAC.

    Returns dict(rotations (N, 3, 3), translations (N, 3), valid (N,)
    bool, hypothesis (N,) the winning RANSAC row)."""
    n, h, w, _ = flow.shape
    _, points_3d, fg = depth_to_correspondences(depth, k, ref_rotations,
                                                ref_translations)
    target = pixel_grid(h, w, flow.dtype, flow.device) + flow
    valid = fg if occlusion is None else fg & (occlusion > occlusion_threshold)
    vflat = valid.to(flow.dtype).reshape(n, h * w)
    scores = torch.where(vflat > 0, subsample_noise,
                         torch.full_like(subsample_noise, -torch.inf))
    idx = top_k_indices(scores, hypothesis_noise.shape[-1])     # (N, P)
    p3 = torch.take_along_dim(points_3d.reshape(n, h * w, 3), idx[..., None],
                              dim=1)
    p2 = torch.take_along_dim(target.reshape(n, h * w, 2), idx[..., None],
                              dim=1)
    out = ransac_pnp_core(hypothesis_noise, p3, p2, k,
                          torch.take_along_dim(vflat, idx, dim=1),
                          inlier_threshold=inlier_threshold)
    enough = vflat.sum(-1) >= min_valid_points
    finite = (torch.isfinite(out["rotation"]).all(-1).all(-1)
              & torch.isfinite(out["translation"]).all(-1))
    ok = enough & finite & (out["num_inliers"] >= 4)
    return {"rotations": torch.where(ok[:, None, None], out["rotation"],
                                     ref_rotations),
            "translations": torch.where(ok[:, None], out["translation"],
                                        ref_translations),
            "valid": ok, "hypothesis": out["hypothesis"]}


def solve_pose_from_flow(generator: torch.Generator, flow, occlusion, depth,
                         ref_rotations, ref_translations, k,
                         occlusion_threshold: float = 0.5,
                         max_points: int = 1024, num_hypotheses: int = 64,
                         inlier_threshold: float = 3.0,
                         min_valid_points: int = 16) -> dict:
    """:func:`solve_pose_from_flow_core` on noise from ``generator``."""
    n, h, w, _ = flow.shape
    sub, hyp = gumbel_draws(generator, n, h * w, max_points, num_hypotheses)
    return solve_pose_from_flow_core(
        sub.to(flow.device), hyp.to(flow.device), flow, occlusion, depth,
        ref_rotations, ref_translations, k, occlusion_threshold,
        inlier_threshold, min_valid_points)
