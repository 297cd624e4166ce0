"""The port's PnP (``scflow_torch/geometry/pnp.py``) and flow → pose
(``scflow_torch/models/flow_pose.py``) against the JAX package on the CPU.

Inputs are seeded numpy scenes. Randomness is injected: the JAX side draws
its Gumbel noise from its keys (``ransac_pnp``: ``gumbel(key, (H, N))``;
``solve_pose_from_flow``: ``key, sub = split(key)``, ``gumbel(sub, (N,
H·W))``, then ``gumbel(split(key, N)[i], (64, P))`` per sample) and the
same arrays go into the port's deterministic cores.

Tolerances: the two sides solve the same f32 problems with other
eigen/SVD routines and summation orders (and an eigenvector sign that is
free in exact arithmetic), so poses agree to rounding amplified by the
problem's conditioning. After Gauss-Newton (every path but bare EPnP):
rotation entries atol 2e-4, translations rtol 1e-4 + atol 2e-3 mm, and
exactly where both fall back to the reference pose. Bare EPnP in f32 is
~0.03° and ~0.3 mm from its own float64 result on exact data (the
12×12 eigenproblem's conditioning), on either side; it is held to that
float64 witness instead (see ``test_epnp``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_common import random_rotations
from scflow_torch.geometry import pnp as tpnp
from scflow_torch.models import flow_pose as tflow
from scflow_tpu.geometry import pnp as jpnp
from scflow_tpu.geometry.flow import flow_from_pose_and_depth
from scflow_tpu.models.flow_pose import solve_pose_from_flow

K = np.array([[572.4, 0., 325.3], [0., 573.6, 242.0], [0., 0., 1.]],
             np.float32)
ROT_ATOL = 2e-4
T_TOL = dict(rtol=1e-4, atol=2e-3)


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def scenes(seed: int, b: int = 3, n: int = 64, noise: float = 0.0,
           outliers: int = 0):
    """b scenes of n object points in a ±100 mm box at a random pose ~1 m
    away, projected with K (+ Gaussian pixel noise; the last ``outliers``
    points moved by 40-80 px)."""
    rng = np.random.default_rng(seed)
    p3 = rng.uniform(-100, 100, size=(b, n, 3))
    r = random_rotations(rng, b).astype(np.float64)
    t = np.stack([rng.uniform(-50, 50, b), rng.uniform(-50, 50, b),
                  rng.uniform(700, 1300, b)], -1)
    cam = np.einsum("bij,bnj->bni", r, p3) + t[:, None]
    uvw = cam @ K.T.astype(np.float64)
    xy = uvw[..., :2] / uvw[..., 2:]
    xy += rng.normal(0, noise, size=xy.shape) if noise else 0.0
    if outliers:
        xy[:, -outliers:] += rng.uniform(40, 80, size=(b, outliers, 2)) \
            * rng.choice([-1, 1], size=(b, outliers, 2))
    f32 = np.float32
    return p3.astype(f32), xy.astype(f32), r.astype(f32), t.astype(f32)


def angle_deg(a, b) -> np.ndarray:
    """Angle between rotation batches from ‖a − b‖_F = 2√2·sin(θ/2), in
    float64 (arccos of the trace cannot resolve f32 angles below ~0.02°)."""
    d = np.linalg.norm((np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).reshape(-1, 9),
                       axis=-1)
    return np.degrees(2 * np.arcsin(np.minimum(d / (2 * np.sqrt(2)), 1.0)))


def assert_pose(got, want, rot_atol=ROT_ATOL, t_tol=T_TOL):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=rot_atol)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **t_tol)


KB = np.broadcast_to(K, (3, 3, 3)).copy()


@pytest.mark.parametrize("noise", [0.0, 0.5])
def test_epnp(noise):
    """Bare EPnP against a float64 witness (the port's EPnP on the same
    inputs in float64): the port's f32 result is no further from it than
    2× JAX's f32 result is, + 0.005° and 0.05 mm (measured: port ≤
    0.017° / 0.16 mm, JAX ≤ 0.092° / 3.2 mm); on exact data both are
    within 0.1° and 1 mm of the truth."""
    p3, xy, r, t = scenes(0, noise=noise)
    jr, jt = jax.vmap(lambda a, b: jpnp.epnp(a, b, jnp.asarray(K)))(p3, xy)
    got = tpnp.epnp(t_(p3), t_(xy), t_(KB))
    wr, wt = (v.numpy() for v in tpnp.epnp(t_(p3).double(), t_(xy).double(),
                                           t_(KB).double()))
    dev = {name: (angle_deg(rr, wr).max(),
                  np.linalg.norm(np.asarray(tt, np.float64) - wt, axis=-1).max())
           for name, (rr, tt) in (("jax", (jr, jt)),
                                  ("port", (got[0].numpy(), got[1].numpy())))}
    print(f"EPnP (noise {noise} px) from the f64 witness: {dev}")
    assert dev["port"][0] <= 2 * dev["jax"][0] + 0.005
    assert dev["port"][1] <= 2 * dev["jax"][1] + 0.05
    if noise == 0.0:
        for rr, tt in ((jr, jt), got):
            assert angle_deg(rr, r).max() < 0.1
            assert np.linalg.norm(np.asarray(tt) - t, axis=-1).max() < 1.0


def test_refine_pose_gn_and_solve_pnp_with_weights():
    """GN from a perturbed start with zero-weight corrupted points, and
    the whole EPnP + GN solve."""
    p3, xy, r, t = scenes(1, noise=0.5)
    xy[:, -10:] += 300.0
    w = np.ones(p3.shape[:2], np.float32)
    w[:, -10:] = 0.0
    # a small rotation about z and a 20 mm shift as the start
    c, s = np.cos(0.05), np.sin(0.05)
    rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    r0 = np.einsum("ij,bjk->bik", rz, r).astype(np.float32)
    t0 = (t + np.float32(20.0)).astype(np.float32)
    jk = jnp.asarray(K)
    want = jax.vmap(lambda a, b, c_, d, e: jpnp.refine_pose_gn(
        a, b, c_, d, jk, e, iters=5))(r0, t0, p3, xy, w)
    got = tpnp.refine_pose_gn(t_(r0), t_(t0), t_(p3), t_(xy), t_(KB), t_(w),
                              iters=5)
    assert_pose(got, want)
    want = jax.vmap(lambda a, b, e: jpnp.solve_pnp(a, b, jk, e))(p3, xy, w)
    got = tpnp.solve_pnp(t_(p3), t_(xy), t_(KB), t_(w))
    assert_pose(got, want)


def test_ransac_pnp_core_with_jax_draws():
    """64 hypotheses of 6 points over 200 points, 40 of them outliers and
    20 of weight 0; the same draws on both sides choose the same
    hypothesis, inliers and pose. ``ransac_pnp`` with its own draws finds
    the same inlier set's pose (within the noise: 1e-3, 0.5 mm)."""
    p3, xy, _, _ = scenes(2, n=200, noise=0.3, outliers=40)
    w = np.ones(p3.shape[:2], np.float32)
    w[:, :20] = 0.0
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    jk = jnp.asarray(K)
    want = jax.vmap(lambda kk, a, b, e: jpnp.ransac_pnp(kk, a, b, jk, e))(
        keys, p3, xy, w)
    noise = np.stack([np.asarray(jax.random.gumbel(kk, (64, 200)))
                      for kk in keys])
    got = tpnp.ransac_pnp_core(t_(noise), t_(p3), t_(xy), t_(KB), t_(w))
    assert_pose((got["rotation"], got["translation"]),
                (want["rotation"], want["translation"]))
    np.testing.assert_array_equal(got["inliers"].numpy(),
                                  np.asarray(want["inliers"]))
    np.testing.assert_array_equal(got["num_inliers"].numpy(),
                                  np.asarray(want["num_inliers"]))
    assert (got["num_inliers"] >= 130).all()      # the outliers are out
    # the public function draws its own noise from a generator
    drawn = tpnp.ransac_pnp(torch.Generator().manual_seed(0), t_(p3), t_(xy),
                            t_(KB), t_(w))
    assert (drawn["num_inliers"] >= 130).all()
    assert_pose((drawn["rotation"], drawn["translation"]),
                (got["rotation"], got["translation"]), rot_atol=1e-3,
                t_tol=dict(rtol=1e-3, atol=0.5))


def jax_hypothesis_counts(noise, p3, p2, k, w) -> np.ndarray:
    """JAX's per-hypothesis inlier counts inside ``ransac_pnp`` (−1 for a
    non-finite residual) on these draws: its sampling, ``epnp`` and scoring
    restated outside the jitted function, which returns none of them."""
    jk = jnp.asarray(k)
    scores = jnp.log(jnp.maximum(w, 1e-12))[None, :] + noise
    _, idx = jax.lax.top_k(scores, 6)
    r, t = jax.vmap(lambda a, b: jpnp.epnp(a, b, jk))(p3[idx], p2[idx])
    res = np.linalg.norm(np.asarray(jax.vmap(
        lambda rr, tt: jpnp.reprojection_residual(rr, tt, p3, p2, jk))(r, t)),
        axis=-1)
    counts = ((res < 3.0) & (w > 0)).sum(-1)
    return np.where(~np.isfinite(res).all(-1), -1, counts)


def assert_ransac_like_witness(key, p3, p2, k, w) -> dict:
    """The port's f32 ``ransac_pnp_core`` on one sample, with the Gumbel
    draws of ``key`` (JAX's ``ransac_pnp``'s), against its float64 witness
    (the same core in float64): the f32 winner scores, in the witness,
    what the witness's own winner scores; and refinement ends with no
    fewer inliers than the winning hypothesis had, unless JAX's
    ``ransac_pnp`` on the same inputs and key does the same."""
    noise = np.asarray(jax.random.gumbel(key, (64, p3.shape[0])))
    args = [t_(noise), t_(p3), t_(p2), t_(k), t_(w)]
    got = tpnp.ransac_pnp_core(*args)
    wit = tpnp.ransac_pnp_core(*[a.double() for a in args])
    best = int(got["hypothesis"])
    assert wit["counts"][best] == wit["counts"].max(), (
        best, got["counts"].tolist(), wit["counts"].tolist())
    if got["num_inliers"] < got["counts"][best]:
        want = jpnp.ransac_pnp(key, p3, p2, jnp.asarray(k), w)
        jax_counts = jax_hypothesis_counts(noise, p3, p2, k, w)
        assert int(want["num_inliers"]) < jax_counts.max(), (
            int(got["num_inliers"]), int(got["counts"][best]))
    return got


SMALL_K = np.array([[500., 0., 32.], [0., 500., 32.], [0., 0., 1.]],
                   np.float32)


def small_object_scene(seed: int, n: int = 192, radius: float = 20.0):
    """The RAFT eval test's geometry, where minimal samples are
    ill-conditioned: n points on the camera-facing half of a 20 mm sphere
    ~600 mm away, 500 px focal length (the object spans ~35 px), 0.3 px of
    noise, the first 10% moved 5-15 px, the last 8 of weight 0."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r = random_rotations(rng, 1)[0].astype(np.float64)
    t = np.array([rng.uniform(-10, 10), rng.uniform(-10, 10),
                  rng.uniform(550, 650)])
    d[(d @ r.T)[:, 2] > 0] *= -1
    p3 = radius * d
    uvw = (p3 @ r.T + t) @ SMALL_K.T.astype(np.float64)
    xy = uvw[:, :2] / uvw[:, 2:] + rng.normal(0, 0.3, (n, 2))
    m = n // 10
    xy[:m] += rng.uniform(5, 15, (m, 2)) * rng.choice([-1, 1], (m, 2))
    w = np.ones(n, np.float32)
    w[-8:] = 0.0
    return p3.astype(np.float32), xy.astype(np.float32), w


@pytest.mark.parametrize("seed", range(8))
def test_ransac_pnp_core_small_object_against_witness(seed):
    """64 hypotheses of 6 points on a small, distant object, where f32
    EPnP in the JAX package moves hypotheses across the 3 px threshold
    (before EPnP's eigenproblem and GN's normal equations went to float64,
    the port's f32 winner scored 14 inliers in the witness against its
    best 39 (seed 3) and 76 (seed 7), and refinement from a 73-inlier
    winner ended at 7 (seed 6)): held by
    :func:`assert_ransac_like_witness`; the refined pose within 0.01° and
    0.05 mm of the witness's where both refine the same winner."""
    p3, xy, w = small_object_scene(seed)
    got = assert_ransac_like_witness(jax.random.PRNGKey(100 + seed), p3, xy,
                                     SMALL_K, w)
    noise = np.asarray(jax.random.gumbel(jax.random.PRNGKey(100 + seed),
                                         (64, p3.shape[0])))
    wit = tpnp.ransac_pnp_core(*[t_(a).double()
                                 for a in (noise, p3, xy, SMALL_K, w)])
    if int(got["hypothesis"]) == int(wit["hypothesis"]) and got["num_inliers"]:
        assert angle_deg(got["rotation"][None], wit["rotation"][None])[0] \
            < 0.01
        assert float((got["translation"].double()
                      - wit["translation"]).norm()) < 0.05


def flow_scene(n: int, size: int = 128, box=(32, 96)):
    """tests/test_flow_pose.py's scene: a paraboloid depth patch ~800 mm
    away over ``box`` of a size² frame, random reference and GT poses."""
    k = np.tile(np.array([[400., 0., size / 2], [0., 400., size / 2],
                          [0., 0., 1.]], np.float32), (n, 1, 1))
    yy, xx = np.meshgrid(np.arange(size, dtype=np.float32),
                         np.arange(size, dtype=np.float32), indexing="ij")
    bump = 800.0 + 0.02 * ((xx - size / 2) ** 2 + (yy - size / 2) ** 2)
    depth = np.zeros((n, size, size), np.float32)
    a, b = box
    depth[:, a:b, a:b] = bump[a:b, a:b]
    rng = np.random.default_rng(n)
    ref_r = random_rotations(rng, n)
    ref_t = np.tile(np.array([0., 0., 800.], np.float32), (n, 1))
    gt_r = random_rotations(rng, n)
    gt_t = (ref_t + rng.uniform(-40, 40, size=(n, 3))).astype(np.float32)
    flow = np.asarray(flow_from_pose_and_depth(ref_r, ref_t, gt_r, gt_t,
                                               depth, k, invalid_num=400.0))
    return dict(flow=flow, depth=depth, ref_r=ref_r, ref_t=ref_t, k=k,
                gt_r=gt_r, gt_t=gt_t)


def jax_flow_draws(seed: int, n: int, pixels: int, max_points: int = 1024,
                   hypotheses: int = 64):
    """The Gumbel draws of the JAX ``solve_pose_from_flow(PRNGKey(seed))``."""
    key, sub = jax.random.split(jax.random.PRNGKey(seed))
    subsample = np.asarray(jax.random.gumbel(sub, (n, pixels)))
    hyp = np.stack([np.asarray(jax.random.gumbel(kk, (hypotheses, max_points)))
                    for kk in jax.random.split(key, n)])
    return subsample, hyp


CASES = {
    # perfect flow (more valid pixels than the 1024-point budget)
    "perfect": dict(n=3),
    # a corrupted region marked occluded
    "occlusion": dict(n=2, corrupt=True),
    # 16×16 = 256 valid pixels < 1024: the subsample ties at −inf. The
    # narrow patch leaves the lateral translation weakly held: f32 GN ends
    # up to 0.02 mm apart on the two sides (each within 0.02 mm of the
    # GT), so translations atol 0.05 mm
    "few_points": dict(n=2, box=(56, 72), t_tol=dict(rtol=1e-4, atol=0.05)),
    # no valid pixel in sample 1 (fallback), 12 < 16 in sample 0 (fallback)
    "fallback": dict(n=2, empty=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_solve_pose_from_flow_core_with_jax_draws(case):
    opts = CASES[case]
    sc = flow_scene(opts["n"], box=opts.get("box", (32, 96)))
    flow, depth, occ = sc["flow"], sc["depth"], None
    if opts.get("corrupt"):
        flow = flow.copy()
        flow[:, 32:64, 32:96] += 35.0
        occ = np.ones(depth.shape, np.float32)
        occ[:, 32:64, 32:96] = 0.0
    if opts.get("empty"):
        depth = np.zeros_like(depth)
        depth[0, 60:63, 60:64] = 800.0          # 12 pixels
    n, h, w = depth.shape
    seed = 11
    want = solve_pose_from_flow(jax.random.PRNGKey(seed), flow, occ, depth,
                                sc["ref_r"], sc["ref_t"], sc["k"])
    sub, hyp = jax_flow_draws(seed, n, h * w)
    got = tflow.solve_pose_from_flow_core(
        t_(sub), t_(hyp), t_(flow), None if occ is None else t_(occ),
        t_(depth), t_(sc["ref_r"]), t_(sc["ref_t"]), t_(sc["k"]))
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))
    assert_pose((got["rotations"], got["translations"]),
                (want["rotations"], want["translations"]),
                t_tol=opts.get("t_tol", T_TOL))
    valid = got["valid"].numpy()
    if case == "fallback":
        assert not valid.any()
        np.testing.assert_array_equal(got["rotations"].numpy(), sc["ref_r"])
        np.testing.assert_array_equal(got["translations"].numpy(),
                                      sc["ref_t"])
    else:     # the GT pose, within tests/test_flow_pose.py's bounds
        assert valid.all()
        ang = angle_deg(got["rotations"].numpy(), sc["gt_r"])
        dt = np.linalg.norm(got["translations"].numpy() - sc["gt_t"], axis=-1)
        assert ang.max() < 0.5 and dt.max() < 5.0, (ang, dt)


def test_solve_pose_from_flow_draws_from_generator():
    """The public function: the same generator seed gives the same pose,
    and a perfect flow gives the GT pose."""
    sc = flow_scene(2)
    args = [t_(sc[k]) for k in ("flow",)] + [None] + [
        t_(sc[k]) for k in ("depth", "ref_r", "ref_t", "k")]
    outs = [tflow.solve_pose_from_flow(torch.Generator().manual_seed(0),
                                       *args) for _ in range(2)]
    for key in ("rotations", "translations", "valid"):
        assert torch.equal(outs[0][key], outs[1][key]), key
    assert outs[0]["valid"].all()
    dt = (outs[0]["translations"] - t_(sc["gt_t"])).norm(dim=-1)
    assert dt.max() < 5.0
