"""Batched PnP: EPnP, Gauss-Newton refinement and fixed-budget RANSAC
(port of ``scflow_tpu/geometry/pnp.py``).

Every function takes any leading batch axes where the JAX package takes
one sample and ``vmap``s. Variable point counts are weight masks. All
products are elementwise sums (:func:`_mm`), so no TF32 setting reaches
them, as the JAX package forces f32 matmuls here. Two small solves run in
float64 whatever the input type, where f32 rounding decides RANSAC's
winner and the refined pose: EPnP's 12×12 eigenproblem and Gauss-Newton's
6×6 normal equations (see ``ROADMAP.md``, Queue 3). RANSAC is split
into its draws and a deterministic core: :func:`ransac_pnp` draws the
Gumbel noise from a ``torch.Generator`` and :func:`ransac_pnp_core` takes
it, so another source of draws (the JAX package's keys, in the tests) can
be fed in.
"""
from __future__ import annotations

import torch

from .rotation import axis_angle_to_matrix

_EPS = 1e-9


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., m, k) @ (..., k, n) as an elementwise f32 sum; broadcasts."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a⁻¹·b without the error check (and, on the card, the host sync) of
    ``torch.linalg.solve``: a singular system gives non-finite values, as
    ``jnp.linalg.solve`` does, which RANSAC scores as a failed hypothesis."""
    return torch.linalg.solve_ex(a, b).result


def _weighted_mean(x: torch.Tensor, w: torch.Tensor, dim: int = -2):
    wsum = w.sum(dim, keepdim=True)
    return (x * w).sum(dim, keepdim=True) / wsum.clamp_min(_EPS)


def _kabsch(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor):
    """Weighted rigid alignment dst ≈ R·src + t. src, dst (..., N, 3);
    w (..., N, 1) non-negative. Returns R (..., 3, 3), t (..., 3)."""
    mu_s = _weighted_mean(src, w)
    mu_d = _weighted_mean(dst, w)
    cs = (src - mu_s) * w
    cd = dst - mu_d
    u, _, vt = torch.linalg.svd(_mm(_t(cs), cd))
    v, ut = _t(vt), _t(u)
    d = torch.sign(torch.linalg.det(_mm(v, ut)))
    s = torch.ones(d.shape + (3,), dtype=d.dtype, device=d.device)
    s = torch.cat([s[..., :2], d[..., None]], dim=-1)
    r = _mm(v * s[..., None, :], ut)
    t = mu_d[..., 0, :] - _mm(r, mu_s[..., 0, :, None])[..., 0]
    return r, t


def _control_points(points_3d: torch.Tensor, w: torch.Tensor):
    """EPnP control points (..., 4, 3): the weighted centroid, then the
    centroid plus each principal axis scaled by its standard deviation."""
    c0 = _weighted_mean(points_3d, w)
    centered = (points_3d - c0) * w.clamp_min(0.0).sqrt()
    cov = _mm(_t(centered), centered) / w.sum((-2, -1))[..., None, None] \
        .clamp_min(_EPS)
    eigval, eigvec = torch.linalg.eigh(cov)
    # floor for degenerate (planar) sets
    axes = eigvec * eigval.clamp_min(1e-6).sqrt()[..., None, :]
    return torch.cat([c0, c0 + _t(axes)], dim=-2)


def _barycentric(points_3d: torch.Tensor, ctrl: torch.Tensor):
    """Barycentric coordinates (..., N, 4) of points w.r.t. 4 control
    points: solve [ctrlᵀ; 1]·α = [p; 1]."""
    ones = torch.ones_like(ctrl[..., :1, :1])
    a = torch.cat([_t(ctrl), ones.expand(ctrl.shape[:-2] + (1, 4))], dim=-2)
    b = torch.cat([_t(points_3d),
                   ones.expand(points_3d.shape[:-2] + (1, points_3d.shape[-2]))],
                  dim=-2)
    return _t(_solve(a, b))


def epnp(points_3d: torch.Tensor, points_2d: torch.Tensor, k: torch.Tensor,
         weights: torch.Tensor | None = None):
    """EPnP with a Kabsch closure. points_3d (..., N, 3) object frame,
    points_2d (..., N, 2) pixels, k (..., 3, 3), weights (..., N) (0
    disables a correspondence). Returns (R (..., 3, 3), t (..., 3))."""
    n = points_3d.shape[-2]
    if weights is None:
        weights = torch.ones_like(points_3d[..., 0])
    w = weights[..., None]
    ctrl_w = _control_points(points_3d, w)
    alpha = _barycentric(points_3d, ctrl_w)                     # (..., N, 4)

    fu, fv = k[..., 0, 0, None, None], k[..., 1, 1, None, None]
    uc, vc = k[..., 0, 2, None], k[..., 1, 2, None]
    u, v = points_2d[..., 0], points_2d[..., 1]
    # two rows per point over the 12 control-point coordinates:
    # [a_j fu, 0, a_j (uc − u)] and [0, a_j fv, a_j (vc − v)]
    zeros = torch.zeros_like(alpha)
    mx = torch.stack([alpha * fu, zeros, alpha * (uc - u)[..., None]], dim=-1)
    my = torch.stack([zeros, alpha * fv, alpha * (vc - v)[..., None]], dim=-1)
    m = torch.cat([mx.reshape(mx.shape[:-3] + (n, 12)),
                   my.reshape(my.shape[:-3] + (n, 12))], dim=-2)
    wm = torch.cat([w, w], dim=-2)
    # MᵀM's smallest eigenvector is formed and solved in float64: in f32
    # its error (~eps·λmax / gap) moves a 6-point hypothesis by ~0.1° and
    # flips inliers across RANSAC's threshold (a deviation from the JAX
    # package, which solves in f32)
    m64 = m.to(torch.float64)
    _, eigvec = torch.linalg.eigh(_mm(_t(m64 * wm.to(torch.float64)), m64))
    # control points in the camera frame, up to scale and sign
    vkernel = eigvec[..., :, 0].reshape(eigvec.shape[:-2] + (4, 3)) \
        .to(points_3d.dtype)

    def pdist(c):
        diff = c[..., :, None, :] - c[..., None, :, :]
        return (diff.square().sum(-1) + _EPS).sqrt()

    dist_w, dist_c = pdist(ctrl_w), pdist(vkernel)
    beta = ((dist_c * dist_w).sum((-2, -1))
            / dist_c.square().sum((-2, -1)).clamp_min(_EPS))
    ctrl_c = vkernel * beta[..., None, None]
    # flip to positive net depth
    z_mean = (_mm(alpha, ctrl_c)[..., 2] * w[..., 0]).sum(-1)
    ctrl_c = torch.where((z_mean < 0)[..., None, None], -ctrl_c, ctrl_c)
    return _kabsch(points_3d, _mm(alpha, ctrl_c), w)


def reprojection_residual(r, t, points_3d, points_2d, k, eps: float = 1e-8):
    """Per-point residual (..., N, 2): projection of R·p + t minus the
    observation."""
    p_cam = _mm(points_3d, _t(r)) + t[..., None, :]
    uvw = _mm(p_cam, _t(k))
    return uvw[..., :2] / (uvw[..., 2:3] + eps) - points_2d


def refine_pose_gn(r, t, points_3d, points_2d, k, weights=None,
                   iters: int = 5, damping: float = 1e-6):
    """Damped Gauss-Newton on the reprojection error, ``iters`` steps:
    left-multiplied axis-angle update of R, additive update of t."""
    if weights is None:
        weights = torch.ones_like(points_3d[..., 0])
    eye = torch.eye(6, dtype=torch.float64, device=points_3d.device)
    ww = torch.cat([weights, weights], dim=-1)[..., None].to(torch.float64)
    fu, fv = k[..., 0, 0, None], k[..., 1, 1, None]
    for _ in range(iters):
        p_cam = _mm(points_3d, _t(r)) + t[..., None, :]
        x, y, z = p_cam.unbind(-1)
        zi = 1.0 / z.clamp_min(1e-6)
        zero = torch.zeros_like(zi)
        du = torch.stack([fu * zi, zero, -fu * x * zi * zi], dim=-1)
        dv = torch.stack([zero, fv * zi, -fv * y * zi * zi], dim=-1)
        # d p_cam / d ω = −[p_cam]×, d p_cam / d t = I
        px = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                         dim=-1).reshape(p_cam.shape + (3,))
        j_rot_u = -(du[..., :, None] * px).sum(-2)
        j_rot_v = -(dv[..., :, None] * px).sum(-2)
        jac = torch.cat([torch.cat([j_rot_u, du], dim=-1),
                         torch.cat([j_rot_v, dv], dim=-1)], dim=-2)
        res = reprojection_residual(r, t, points_3d, points_2d, k)
        rvec = torch.cat([res[..., 0], res[..., 1]], dim=-1)[..., None]
        # the normal equations are formed and solved in float64: rotation
        # about the camera's origin and translation are nearly collinear
        # for an object far from the camera, and in f32 the step's error
        # along that direction moves the pose by up to a millimetre an
        # iteration, where inputs 1e-5 px apart should move it by 1e-5 mm
        # (a deviation from the JAX package, which solves in f32)
        jac, rvec = jac.to(torch.float64), rvec.to(torch.float64)
        jtj = _mm(_t(jac * ww), jac) + damping * eye
        jtr = _mm(_t(jac * ww), rvec)
        delta = -_solve(jtj, jtr)[..., 0].to(r.dtype)
        r = _mm(axis_angle_to_matrix(delta[..., :3]), r)
        t = t + delta[..., 3:]
    return r, t


def solve_pnp(points_3d, points_2d, k, weights=None, refine_iters: int = 5):
    """EPnP and Gauss-Newton refinement (the ``cv2.solvePnP(EPNP)``
    replacement). Returns (R, t)."""
    r, t = epnp(points_3d, points_2d, k, weights)
    if refine_iters > 0:
        r, t = refine_pose_gn(r, t, points_3d, points_2d, k, weights,
                              iters=refine_iters)
    return r, t


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest scores along the last axis, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def gumbel(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise −log(−log U) drawn on the generator's device."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(tuple(shape), generator=generator,
                   device=generator.device).clamp_min(tiny)
    return -torch.log(-torch.log(u))


def ransac_pnp_core(noise: torch.Tensor, points_3d: torch.Tensor,
                    points_2d: torch.Tensor, k: torch.Tensor,
                    weights: torch.Tensor | None = None,
                    sample_size: int = 6, inlier_threshold: float = 3.0,
                    refine_iters: int = 5) -> dict:
    """Fixed-budget parallel RANSAC-EPnP on given Gumbel ``noise``
    (..., H, N), one row per hypothesis: each hypothesis takes the
    ``sample_size`` points of largest log(weight) + noise, EPnP solves all
    of them, the one with the most inliers (the first of equals; −1 for a
    hypothesis with a non-finite residual) is refined by inlier-weighted
    Gauss-Newton. points_3d (..., N, 3), points_2d (..., N, 2), k (..., 3,
    3), weights (..., N) in [0, 1].

    Returns dict(rotation, translation, inliers (..., N), num_inliers,
    hypothesis (the winning row), counts (..., H) each hypothesis's
    inliers before refinement)."""
    if weights is None:
        weights = torch.ones_like(points_3d[..., 0])
    scores = weights.clamp_min(1e-12).log()[..., None, :] + noise
    idx = top_k_indices(scores, sample_size)                   # (..., H, S)

    def pick(x):
        return torch.take_along_dim(x[..., None, :, :], idx[..., None], dim=-2)

    kh = k[..., None, :, :]
    r_h, t_h = epnp(pick(points_3d), pick(points_2d), kh)
    res_h = reprojection_residual(r_h, t_h, points_3d[..., None, :, :],
                                  points_2d[..., None, :, :], kh).norm(dim=-1)
    valid = weights > 0
    inl_h = (res_h < inlier_threshold) & valid[..., None, :]
    counts = inl_h.sum(-1)
    counts = torch.where((~torch.isfinite(res_h)).any(-1),
                         torch.full_like(counts, -1), counts)
    best = counts.argmax(-1)

    def at_best(x):
        return torch.take_along_dim(
            x, best.reshape(best.shape + (1,) * (x.dim() - best.dim())),
            dim=best.dim()).squeeze(best.dim())

    inl = at_best(inl_h).to(points_3d.dtype)
    r_fin, t_fin = refine_pose_gn(at_best(r_h), at_best(t_h), points_3d,
                                  points_2d, k, weights=inl * weights,
                                  iters=refine_iters)
    res_fin = reprojection_residual(r_fin, t_fin, points_3d, points_2d,
                                    k).norm(dim=-1)
    inl_fin = (res_fin < inlier_threshold) & valid
    return {"rotation": r_fin, "translation": t_fin, "inliers": inl_fin,
            "num_inliers": inl_fin.sum(-1), "hypothesis": best,
            "counts": counts}


def ransac_pnp(generator: torch.Generator, points_3d, points_2d, k,
               weights=None, num_hypotheses: int = 64, sample_size: int = 6,
               inlier_threshold: float = 3.0, refine_iters: int = 5) -> dict:
    """:func:`ransac_pnp_core` with ``num_hypotheses`` rows of Gumbel noise
    drawn from ``generator`` (the replacement of ``cv2.solvePnPRansac``)."""
    noise = gumbel(generator, points_3d.shape[:-2]
                   + (num_hypotheses, points_3d.shape[-2]))
    return ransac_pnp_core(noise.to(points_3d.device), points_3d, points_2d,
                           k, weights, sample_size, inlier_threshold,
                           refine_iters)
