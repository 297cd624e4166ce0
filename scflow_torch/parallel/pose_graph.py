"""Scene pose-graph refinement over multi-object images (port of
``scflow_tpu/parallel/pose_graph.py``).

Objects seen in one image share a rigid scene, so after per-object
refinement a shared camera correction is solved from all of them. A camera
correction is gauge-equivalent to composing every object pose, so the
joint (δc, δp_i) Gauss–Newton system is singular; it is solved as its
regularised limit, alternating block descent:

1. camera step: the normal-equation blocks summed over all objects,
   (Σ_i H_i + λI) δc = Σ_i b_i;
2. object step (full mode only): independent damped GN solves per object
   at the corrected camera.

Everything is true f32 whatever the process sets for TF32 (these 6×6
systems reach condition ~1e8): the 3×3 products are elementwise f32 sums
(``geometry/se3.py``'s ``matmul3`` / ``matvec3``) and the normal
equations reductions, so no matmul runs before the solve, and the 6×6
solve gives the same bits with TF32 on and off (chip_smoke checks the
whole graph both ways). It is free of host syncs:
``torch.linalg.solve_ex(check_errors=False)`` returns inf/NaN for a
singular system, as JAX's solve does, and the finite guards act with
``torch.where``. The eval loop computes the dense per-slot targets once
per packed batch (:func:`slot_targets`) and solves each image's group of
slots apart (:func:`pose_graph_group`).

:func:`solve_pose_graph_sharded` splits the objects over the ranks of a
process group: the camera sums are the only cross-rank part (two
all-reduces per iteration). The JAX package's ``_precond_solve`` is dead
code there and is not ported.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..geometry.projection import depth_to_correspondences, pixel_grid
from ..geometry.rotation import axis_angle_to_matrix
from ..geometry.se3 import matmul3, matvec3, transform_points
from .prng import pick_points


def _object_jacobian(points, r, t, k, weights, eps: float = 1e-2):
    """Per-object GN jacobians (..., 2P, 6) of the reprojection residuals
    [all u; all v] w.r.t. a left-multiplied axis-angle + translation
    update of the camera-frame points (the object pose and the shared
    camera correction act alike; the camera block is shared by sharing).
    ``eps`` clamps 1/z: a point driven to z≈0 would otherwise give entries
    ~1e18 whose normal equations overflow f32. Rows are scaled by √w."""
    p_cam = transform_points(r, t, points)
    x, y, z = p_cam.unbind(-1)
    zi = 1.0 / z.clamp_min(eps)
    fu, fv = k[..., 0, 0, None], k[..., 1, 1, None]
    zero = torch.zeros_like(zi)
    du = torch.stack([fu * zi, zero, -fu * x * zi * zi], dim=-1)
    dv = torch.stack([zero, fv * zi, -fv * y * zi * zi], dim=-1)
    px = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                     dim=-1).unflatten(-1, (3, 3))
    j_rot_u = -(du[..., :, None] * px).sum(-2)
    j_rot_v = -(dv[..., :, None] * px).sum(-2)
    j = torch.cat([torch.cat([j_rot_u, du], dim=-1),
                   torch.cat([j_rot_v, dv], dim=-1)], dim=-2)
    w = torch.cat([weights, weights], dim=-1)[..., None]
    return j * w.clamp_min(0.0).sqrt()


def _residuals(points, target_2d, r, t, k, weights, eps: float = 1e-8):
    """√w-scaled reprojection residuals (..., 2P), all u then all v."""
    p_cam = transform_points(r, t, points)
    uvw = matvec3(k[..., None, :, :], p_cam)
    xy = uvw[..., :2] / (uvw[..., 2:3] + eps)
    res = (xy - target_2d) * weights.clamp_min(0.0).sqrt()[..., None]
    return res.transpose(-1, -2).flatten(-2)


def _gn_blocks(points, target_2d, r, t, k, weights, damping: float):
    """One GN linearisation per object: (H + λI (..., 6, 6), b (..., 6)).
    JᵀJ and Jᵀr are sums over the 2P rows as reductions (pairwise on the
    CPU, a tree on the card) rather than matmuls: in these ill-conditioned
    systems a GEMM's running sums left the camera solve up to 4× further
    from a float64 witness than XLA's."""
    j = _object_jacobian(points, r, t, k, weights)
    res = _residuals(points, target_2d, r, t, k, weights)
    h = (j[..., :, :, None] * j[..., :, None, :]).sum(-3)
    b = -(j * res[..., None]).sum(-2)
    eye = torch.eye(6, dtype=h.dtype, device=h.device)
    return h + damping * eye, b


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a⁻¹b for (..., 6, 6) and (..., 6) without a host check of the
    factorisation: a singular system gives inf/NaN, as JAX's solve does."""
    return torch.linalg.solve_ex(a, b[..., None],
                                 check_errors=False).result[..., 0]


def _compose(delta: torch.Tensor, r: torch.Tensor, t: torch.Tensor):
    """exp(δ)ₗ applied to poses: δ (..., 6) acts on r (..., 3, 3), t (..., 3)."""
    dr = axis_angle_to_matrix(delta[..., :3])
    return matmul3(dr, r), matvec3(dr, t) + delta[..., 3:]


def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x).all(-1, keepdim=True), x, 0.0)


def solve_pose_graph(points, target_2d, rotations, translations, k, weights,
                     object_valid=None, damping: float = 1e-3,
                     iterations: int = 3, camera_only: bool = False) -> dict:
    """Joint scene refinement: a shared camera correction plus, unless
    ``camera_only``, per-object poses.

    points (..., N, P, 3) object-frame points; target_2d (..., N, P, 2)
    observed pixels; rotations (..., N, 3, 3), translations (..., N, 3) the
    current poses; k (3, 3) or (..., N, 3, 3) intrinsics (each
    object's crop carries its own K; the correction acts in the camera
    frame, before K, and stays shared); weights (..., N, P) per-point
    confidence (0 drops a point); object_valid (..., N) 0/1 for padded
    slots. A non-finite camera solve is skipped, a non-finite object solve
    freezes that object.

    ``camera_only``: per-object re-solves inherit the flow targets' noise
    and degraded the pose head's accuracy in the JAX package's ablation,
    while the camera block averages thousands of points.

    Returns dict(rotations, translations, camera_rotation (..., 3, 3),
    camera_translation (..., 3)) with the correction folded into the poses.
    """
    n = points.shape[-3]
    lead = points.shape[:-3]
    ov = (torch.ones(lead + (n,), dtype=points.dtype, device=points.device)
          if object_valid is None else object_valid.to(points.dtype))
    k_b = k.expand(lead + (n, 3, 3))
    eye = torch.eye(6, dtype=points.dtype, device=points.device)

    def camera_step(r, t, cam_r, cam_t):
        h_ii, b_i = _gn_blocks(points, target_2d, r, t, k_b, weights,
                               damping)
        h_c = (h_ii * ov[..., None, None]).sum(-3)
        b_c = (b_i * ov[..., None]).sum(-2)
        delta_c = _finite_or_zero(_solve(h_c + damping * eye, b_c))
        r, t = _compose(delta_c[..., None, :], r, t)
        cam_r, cam_t = _compose(delta_c, cam_r, cam_t)
        return r, t, cam_r, cam_t

    def object_step(r, t):
        h_ii, b_i = _gn_blocks(points, target_2d, r, t, k_b, weights,
                               damping)
        delta_p = _finite_or_zero(_solve(h_ii, b_i) * ov[..., None])
        return _compose(delta_p, r, t)

    r, t = rotations, translations
    cam_r = torch.eye(3, dtype=r.dtype, device=r.device).expand(
        lead + (3, 3))
    cam_t = torch.zeros(lead + (3,), dtype=t.dtype, device=t.device)
    for _ in range(iterations):
        r, t, cam_r, cam_t = camera_step(r, t, cam_r, cam_t)
        if not camera_only:
            r, t = object_step(r, t)
    return {"rotations": r, "translations": t,
            "camera_rotation": cam_r, "camera_translation": cam_t}


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """bf16/f16 → f32; f32 and f64 (a float64 witness) stay."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def slot_targets(flow, occlusion, depth, ref_rotations, ref_translations,
                 k, occlusion_threshold: float = 0.5):
    """The pose graph's per-slot inputs from the refiner's outputs of S
    slots: the object-frame points (S, HW, 3) rendered at the reference
    pose (``depth`` (S, H, W), crop intrinsics ``k`` (S, 3, 3)), their
    pixels displaced by the predicted ``flow`` (S, H, W, 2) as targets
    (S, HW, 2), and the valid mask (S, HW) as 0/1: foreground and, with
    ``occlusion`` (S, H, W), visible above the threshold."""
    flow, depth = _at_least_f32(flow), _at_least_f32(depth)
    s, h, w, _ = flow.shape
    k_b = _at_least_f32(k).expand(s, 3, 3)
    _, points_3d, valid = depth_to_correspondences(depth, k_b, ref_rotations,
                                                   ref_translations)
    target_2d = pixel_grid(h, w, flow.dtype, flow.device) + flow
    if occlusion is not None:
        valid = valid & (occlusion > occlusion_threshold)
    return (points_3d.reshape(s, h * w, 3), target_2d.reshape(s, h * w, 2),
            valid.reshape(s, h * w).to(flow.dtype))


def pose_graph_group(targets: tuple, pred_rotations, pred_translations, k,
                     slots, object_valid, max_points: int = 512,
                     iterations: int = 3, damping: float = 1e-3,
                     camera_only: bool = True) -> dict:
    """One image's pose graph over the slots ``slots`` (N,) of the
    :func:`slot_targets` ``targets`` (padded slots repeat a slot and have
    ``object_valid`` 0): slot j of the group draws its pixels from row j
    of the (N, HW) key table, as the JAX package draws them; an object
    with fewer than 16 valid pixels, a padded slot and a non-finite
    result keep their pose from ``pred_rotations`` / ``pred_translations``
    (per slot, like ``k``).

    One call per image: a call over several images at once would sum the
    normal equations in an order that depends on how many share it, so an
    image's poses would depend on the images packed beside it."""
    points_3d, target_2d, vflat = targets
    hw = vflat.shape[-1]
    v = vflat[slots]                                         # (N, HW)
    idx = pick_points(v, max_points)                         # (N, P)
    flat = slots[:, None] * hw + idx
    weights = v.gather(-1, idx)
    # an object with too few valid pixels cannot anchor the shared camera:
    # weights 0 and object_valid 0 keep its pose at the input
    enough = (v.sum(-1) >= 16).to(v.dtype)
    ov = object_valid.to(v.dtype) * enough
    weights = weights * ov[:, None]
    pred_r, pred_t = pred_rotations[slots], pred_translations[slots]
    out = solve_pose_graph(points_3d.reshape(-1, 3)[flat],
                           target_2d.reshape(-1, 2)[flat], pred_r, pred_t,
                           _at_least_f32(k)[slots], weights, object_valid=ov,
                           damping=damping, iterations=iterations,
                           camera_only=camera_only)
    finite = (torch.isfinite(out["rotations"]).all((-2, -1))
              & torch.isfinite(out["translations"]).all(-1))
    keep = (ov > 0) & finite
    return {
        "rotations": torch.where(keep[:, None, None], out["rotations"],
                                 pred_r),
        "translations": torch.where(keep[:, None], out["translations"],
                                    pred_t),
        "camera_rotation": out["camera_rotation"],
        "camera_translation": out["camera_translation"],
    }


def pose_graph_from_flow(flow, occlusion, depth, ref_rotations,
                         ref_translations, pred_rotations, pred_translations,
                         k, object_valid, occlusion_threshold: float = 0.5,
                         max_points: int = 512, iterations: int = 3,
                         damping: float = 1e-3,
                         camera_only: bool = True) -> dict:
    """Scene pose-graph refinement of one image's N objects from the
    refiner's outputs.

    Each object's targets are the object-frame points rendered at its
    reference pose (``depth`` (N, H, W)) at ``max_points`` valid pixels
    (foreground and ``occlusion`` (N, H, W) above the threshold) drawn as
    the JAX package draws them, displaced by the predicted ``flow`` (N, H,
    W, 2); :func:`solve_pose_graph` then starts from the refined poses
    ``pred_rotations`` / ``pred_translations``. ``k`` is (3, 3) or (N, 3,
    3) per-object crop intrinsics; ``object_valid`` (N,) masks padded
    slots. An object with fewer than 16 valid pixels, a padded slot and a
    non-finite result keep their input pose.

    Returns dict(rotations, translations, camera_rotation,
    camera_translation)."""
    n = flow.shape[0]
    k = k.expand(n, 3, 3)
    targets = slot_targets(flow, occlusion, depth, ref_rotations,
                           ref_translations, k, occlusion_threshold)
    return pose_graph_group(targets, pred_rotations, pred_translations, k,
                            torch.arange(n, device=flow.device), object_valid,
                            max_points=max_points, iterations=iterations,
                            damping=damping, camera_only=camera_only)


def solve_pose_graph_sharded(points, target_2d, rotations, translations, k,
                             weights, damping: float = 1e-3,
                             iterations: int = 3, group=None) -> dict:
    """:func:`solve_pose_graph` in full mode with the objects split over
    the ranks of ``group`` (default: the default process group): every
    argument is this rank's objects (k (3, 3) shared or this rank's (n, 3,
    3)). Each iteration all-reduces the camera sums H_c and b_c, then
    solves the camera and this rank's objects locally; as in the JAX
    package there is no finite guard. Returns this rank's
    dict(rotations, translations)."""
    n = points.shape[0]
    k_b = k.expand(n, 3, 3)
    eye = torch.eye(6, dtype=points.dtype, device=points.device)
    r, t = rotations, translations
    for _ in range(iterations):
        h_ii, b_i = _gn_blocks(points, target_2d, r, t, k_b, weights,
                               damping)
        h_c, b_c = h_ii.sum(0), b_i.sum(0)
        dist.all_reduce(h_c, group=group)
        dist.all_reduce(b_c, group=group)
        r, t = _compose(_solve(h_c + damping * eye, b_c)[None], r, t)
        h_ii, b_i = _gn_blocks(points, target_2d, r, t, k_b, weights,
                               damping)
        r, t = _compose(_solve(h_ii, b_i), r, t)
    return {"rotations": r, "translations": t}
