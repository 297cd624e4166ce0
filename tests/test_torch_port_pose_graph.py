"""The port's scene pose graph against the JAX package's, on the CPU.

- The fixed pixel draw: the port's numpy threefry against
  ``jax.random.bits``, and its picks against ``lax.top_k`` of JAX's own
  Gumbel draw, index for index.
- ``solve_pose_graph`` (both modes), ``pose_graph_from_flow`` (padded
  slots, a starved object, per-object K; both modes) and
  ``solve_pose_graph_sharded`` over 2 gloo ranks against JAX's sharded
  solve on 2 of the 8 virtual CPU devices. The witness is JAX's own
  algorithm in float64 (``jax.enable_x64``), so it owes nothing to the
  port. The port's poses are held to JAX's directly: their distance is at
  most twice JAX's distance from the witness plus 1e-6 (rotation entries)
  or 1e-4 mm (translations), and the port's own distance from the witness
  obeys the same bound. These normal equations reach condition ~1e8, so
  the two f32 results are not closer to each other than to the witness.
  The solves also recover the scenes' GT poses.
- The slice as a whole: ``evaluate_dataset`` with a pose-graph metric on
  a tree written by ``make_synthetic_bop`` (4 classes, 64², 2 iterations,
  budget 4), the port against JAX with the same weights, per instance, for
  the plain metric and the pose graph in both modes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from port_common import perturb
from test_torch_port_bop_eval import (ROT_ATOL, TRANS_ATOL, TRANS_RTOL,
                                      _no_host_tensors)

H = W = 64
SHAPES = [(3, 7), (4, 4096), (16, 256 * 256)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_draw_bits_match_jax(shape):
    """The numpy threefry-2x32 gives ``jax.random.bits(PRNGKey(0))``, and
    the key table is its 23-bit mantissa draw."""
    from scflow_torch.parallel.prng import draw_bits, key_table

    want = np.asarray(jax.random.bits(jax.random.PRNGKey(0), shape,
                                      jnp.uint32))
    got = draw_bits(shape)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        key_table(*shape, torch.device("cpu")).numpy(), want >> 9)


@pytest.mark.parametrize("shape", SHAPES[1:], ids=str)
def test_picks_match_lax_top_k(shape):
    """The pixels the port keeps equal ``lax.top_k`` of JAX's Gumbel
    scores with invalid pixels at -inf, index for index: a dense object,
    a sparse one, one with fewer valid pixels than the 512 kept (the
    -inf ties go to the lower index) and one with none."""
    from scflow_torch.parallel.prng import pick_points

    rng = np.random.default_rng(0)
    n, hw = shape
    valid = (rng.uniform(size=shape) < 0.5).astype(np.float32)
    valid[1] = rng.uniform(size=hw) < 0.2
    valid[2] = 0.0
    valid[2, rng.choice(hw, 300, replace=False)] = 1.0
    valid[3] = 0.0
    gumbel = jax.random.gumbel(jax.random.PRNGKey(0), shape)
    _, want = jax.lax.top_k(jnp.where(valid > 0, gumbel, -jnp.inf), 512)
    got = pick_points(torch.from_numpy(valid), 512)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _rodrigues(aa: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(aa)
    if theta < 1e-12:
        return np.eye(3)
    x, y, z = aa / theta
    kx = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx


def _random_rotations(rng, n: int) -> np.ndarray:
    return np.stack([_rodrigues(rng.normal(size=3)) for _ in range(n)])


def point_scene(n: int = 4, points: int = 80, seed: int = 0):
    """Object points, their GT projections (per-object K) and initial
    poses off by a shared camera error and small per-object errors."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-40, 40, (n, points, 3))
    gt_r = _random_rotations(rng, n)
    gt_t = np.stack([rng.uniform(-100, 100, n), rng.uniform(-100, 100, n),
                     rng.uniform(700, 1100, n)], -1)
    k = np.tile(np.eye(3), (n, 1, 1))
    k[:, 0, 0] = k[:, 1, 1] = rng.uniform(450, 550, n)
    k[:, 0, 2], k[:, 1, 2] = rng.uniform(280, 360, n), rng.uniform(200, 280, n)
    p_cam = np.einsum("nij,npj->npi", gt_r, pts) + gt_t[:, None]
    uvw = np.einsum("nij,npj->npi", k, p_cam)
    target = uvw[..., :2] / uvw[..., 2:]
    cam_r = _rodrigues(np.array([0.02, -0.015, 0.01]))
    init_r = np.einsum("ij,njk->nik", cam_r, gt_r)
    init_t = gt_t @ cam_r.T + np.array([8.0, -5.0, 15.0])
    obj_r = np.stack([_rodrigues(rng.normal(0, 0.01, 3)) for _ in range(n)])
    init_r = np.einsum("nij,njk->nik", obj_r, init_r)
    init_t = init_t + rng.normal(0, 3, (n, 3))
    f32 = np.float32
    return dict(points=pts.astype(f32), target_2d=target.astype(f32),
                rotations=init_r.astype(f32), translations=init_t.astype(f32),
                k=k.astype(f32), weights=np.ones((n, points), f32),
                gt_r=gt_r, gt_t=gt_t)


def flow_scene(n: int = 4, seed: int = 0, per_object_k: bool = False):
    """Curved depth patches (the JAX package's ``make_flow_scene``) at the
    identity reference pose, each seen through its own K if asked; the
    flow moves every foreground pixel to its projection under the GT pose
    (a shared camera error ∘ small per-object errors)."""
    rng = np.random.default_rng(seed)
    depth = np.zeros((n, H, W), np.float32)
    yy, xx = np.mgrid[16:48, 16:48].astype(np.float32)
    for i in range(n):
        depth[i, 16:48, 16:48] = (600.0 + 40.0 * i + 2.0 * (xx - 32)
                                  + 1.5 * (yy - 32)
                                  + 0.08 * ((xx - 32) ** 2 + (yy - 32) ** 2))
    k = np.tile(np.array([[120.0, 0, 32.0], [0, 120.0, 32.0], [0, 0, 1]]),
                (n, 1, 1))
    if per_object_k:
        k[:, 0, 0] = k[:, 1, 1] = rng.uniform(100, 140, n)
        k[:, :2, 2] = rng.uniform(28, 36, (n, 2))
    cam_r = _rodrigues(np.array([0.02, -0.015, 0.01]))
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    flow = np.zeros((n, H, W, 2))
    gt_r, gt_t = np.zeros((n, 3, 3)), np.zeros((n, 3))
    for i in range(n):
        z = depth[i].astype(np.float64)
        p = np.stack([(u - k[i, 0, 2]) / k[i, 0, 0] * z,
                      (v - k[i, 1, 2]) / k[i, 1, 1] * z, z], -1)
        gt_r[i] = cam_r @ _rodrigues(rng.normal(0, 0.003, 3))
        gt_t[i] = cam_r @ rng.normal(0, 1.0, 3) + np.array([5.0, -3.0, 8.0])
        uvw = (p @ gt_r[i].T + gt_t[i]) @ k[i].T
        proj = uvw[..., :2] / uvw[..., 2:]
        flow[i] = np.where((z > 0)[..., None], proj - np.stack([u, v], -1), 0)
    eye = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    return dict(flow=flow.astype(np.float32),
                occ=(depth > 0).astype(np.float32), depth=depth,
                ref_r=eye, ref_t=np.zeros((n, 3), np.float32),
                pred_r=eye.copy(), pred_t=np.zeros((n, 3), np.float32),
                k=k.astype(np.float32), gt_r=gt_r, gt_t=gt_t)


def add_to_gt(s: dict, rotations, translations) -> np.ndarray:
    """Per object of a ``flow_scene``, the mean distance (mm) of its
    visible points under the given pose from the same points under the GT
    pose."""
    v, u = np.mgrid[0:H, 0:W]
    out = []
    for i, k in enumerate(s["k"].astype(np.float64)):
        z = s["depth"][i].astype(np.float64)
        p = np.stack([(u - k[0, 2]) / k[0, 0] * z,
                      (v - k[1, 2]) / k[1, 1] * z, z], -1)[z > 0]
        d = (p @ np.asarray(rotations[i], np.float64).T + translations[i]
             - p @ s["gt_r"][i].T - s["gt_t"][i])
        out.append(np.linalg.norm(d, axis=-1).mean())
    return np.array(out)


def hold_to_jax(got: dict, want: dict, witness: dict) -> dict:
    """The port's poses against JAX's f32 ones: their distance, and the
    port's distance from the float64 witness, each at most 2× JAX's
    distance from the witness plus 1e-6 (rotation entries) or 1e-4 mm
    (translations)."""
    gaps = {}
    for key, extra in (("rotations", 1e-6), ("translations", 1e-4)):
        port, jax_, w = (np.asarray(d[key], np.float64)
                         for d in (got, want, witness))
        to_jax = np.abs(port - jax_).max()
        to_witness = np.abs(port - w).max()
        jax_err = np.abs(jax_ - w).max()
        gaps[key] = dict(port_jax=to_jax, port_witness=to_witness,
                         jax_witness=jax_err)
        assert to_jax <= 2 * jax_err + extra, (key, gaps[key])
        assert to_witness <= 2 * jax_err + extra, (key, gaps[key])
    return gaps


def _f64(x) -> jax.Array:
    return jnp.asarray(np.asarray(x, np.float64))


def jax_solve_witness(inputs: dict, **kw) -> dict:
    """JAX's ``solve_pose_graph`` on the same inputs in float64."""
    from scflow_tpu.parallel.pose_graph import solve_pose_graph as jax_solve

    with jax.enable_x64(True):
        out = jax_solve(*(_f64(v) for v in inputs.values()), **kw)
        return {k: np.asarray(v) for k, v in out.items()}


def jax_flow_witness(s: dict, camera_only: bool) -> dict:
    """JAX's ``pose_graph_from_flow`` (its defaults: threshold 0.5, 512
    points, 3 iterations) in float64, step by step as that function takes
    them. The picks are JAX's f32 Gumbel draw's: under x64
    ``jax.random.gumbel`` draws 64-bit floats, which rank other pixels."""
    from scflow_tpu.geometry.projection import (depth_to_correspondences,
                                                pixel_grid)
    from scflow_tpu.parallel.pose_graph import solve_pose_graph as jax_solve

    n = s["flow"].shape[0]
    vflat = ((s["depth"] > 0) & (s["occ"] > 0.5)).reshape(n, H * W)
    gumbel = jax.random.gumbel(jax.random.PRNGKey(0), (n, H * W))
    _, idx = jax.lax.top_k(jnp.where(vflat, gumbel, -jnp.inf), 512)
    idx = np.asarray(idx)
    with jax.enable_x64(True):
        _, p3, _ = depth_to_correspondences(_f64(s["depth"]), _f64(s["k"]),
                                            _f64(s["ref_r"]),
                                            _f64(s["ref_t"]))
        p2 = np.asarray(pixel_grid(H, W, jnp.float64))[None] + s["flow"]
        p3 = np.take_along_axis(np.asarray(p3).reshape(n, -1, 3),
                                idx[..., None], 1)
        p2 = np.take_along_axis(p2.reshape(n, -1, 2), idx[..., None], 1)
        ov = s["valid"] * (vflat.sum(-1) >= 16)
        weights = np.take_along_axis(vflat, idx, 1) * ov[:, None]
        out = jax_solve(_f64(p3), _f64(p2), _f64(s["pred_r"]),
                        _f64(s["pred_t"]), _f64(s["k"]), _f64(weights),
                        object_valid=_f64(ov), iterations=3,
                        camera_only=camera_only)
        r, t = np.asarray(out["rotations"]), np.asarray(out["translations"])
    keep = (ov > 0) & np.isfinite(r).all((-2, -1)) & np.isfinite(t).all(-1)
    return dict(rotations=np.where(keep[:, None, None], r, s["pred_r"]),
                translations=np.where(keep[:, None], t, s["pred_t"]))


def _torch(d: dict, dtype=None) -> dict:
    return {k: torch.from_numpy(np.array(v)).to(dtype) if dtype
            else torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("camera_only", [True, False],
                         ids=["camera_only", "full"])
def test_solve_pose_graph_matches_jax(camera_only):
    """5 iterations on a 4-object scene with per-object K, against JAX
    and JAX's float64 witness; the solve recovers the GT poses."""
    from scflow_torch.parallel.pose_graph import solve_pose_graph
    from scflow_tpu.parallel.pose_graph import solve_pose_graph as jax_solve

    s = point_scene()
    keys = ("points", "target_2d", "rotations", "translations", "k",
            "weights")
    inputs = {k: s[k] for k in keys}
    want = jax_solve(*(jnp.asarray(v) for v in inputs.values()),
                     iterations=5, camera_only=camera_only)
    got = solve_pose_graph(*_torch(inputs).values(), iterations=5,
                           camera_only=camera_only)
    witness = jax_solve_witness(inputs, iterations=5,
                                camera_only=camera_only)
    gaps = hold_to_jax({k: v.numpy() for k, v in got.items()}, want,
                       witness)
    print(f"solve_pose_graph camera_only={camera_only}: {gaps}")
    np.testing.assert_allclose(got["camera_rotation"].numpy(),
                               np.asarray(want["camera_rotation"]), atol=1e-5)
    t_err = np.abs(got["translations"].numpy() - s["gt_t"]).max()
    assert t_err < (30.0 if camera_only else 1.0)
    if not camera_only:
        r_err = np.abs(got["rotations"].numpy() - s["gt_r"]).max()
        assert r_err < 1e-3


CASES = ["padded", "starved", "per_object_k"]


def flow_case(case: str) -> dict:
    """``flow_scene`` inputs for a case: 4 slots, the last padded with a
    copy of slot 1; 4 objects, one with no visible pixel and one with 380
    (fewer than the 512 kept); 4 objects, each with its own K."""
    s = flow_scene(per_object_k=case == "per_object_k")
    valid = np.ones(4, np.float32)
    if case == "padded":
        for k in ("flow", "occ", "depth", "k"):
            s[k][3] = s[k][1]
        valid[3] = 0.0
    if case == "starved":
        s["occ"][2] = 0.0
        s["occ"][3, :, :] = 0.0
        s["occ"][3, 20:39, 20:40] = 1.0
    s["valid"] = valid
    return s


@pytest.mark.parametrize("camera_only", [True, False],
                         ids=["camera_only", "full"])
@pytest.mark.parametrize("case", CASES)
def test_pose_graph_from_flow_matches_jax(case, camera_only):
    """``pose_graph_from_flow`` against JAX's and JAX's float64 witness; a
    padded slot and an object with no visible pixel keep their input pose
    bit for bit, and every solved object comes near its GT pose. The flow
    is exact, so in full mode its points land within 0.5 mm of their GT
    place (mean); the camera-only mode at least halves that distance and
    leaves at most 8 mm, each object's own error (0.003 rad and 1 mm per
    axis)."""
    from scflow_torch.parallel.pose_graph import pose_graph_from_flow
    from scflow_tpu.parallel.pose_graph import \
        pose_graph_from_flow as jax_pose_graph

    s = flow_case(case)
    keys = ("flow", "occ", "depth", "ref_r", "ref_t", "pred_r", "pred_t",
            "k", "valid")
    want = jax_pose_graph(*(jnp.asarray(s[k]) for k in keys),
                          camera_only=camera_only)
    got = pose_graph_from_flow(*_torch({k: s[k] for k in keys}).values(),
                               camera_only=camera_only)
    got = {k: v.numpy() for k, v in got.items()}
    gaps = hold_to_jax(got, want, jax_flow_witness(s, camera_only))
    frozen = {"padded": [3], "starved": [2], "per_object_k": []}[case]
    for i in frozen:
        np.testing.assert_array_equal(got["rotations"][i], s["pred_r"][i])
        np.testing.assert_array_equal(got["translations"][i], s["pred_t"][i])
    solved = [i for i in range(4) if i not in frozen]
    before = add_to_gt(s, s["pred_r"], s["pred_t"])[solved]
    after = add_to_gt(s, got["rotations"], got["translations"])[solved]
    print(f"pose_graph_from_flow {case} camera_only={camera_only}: {gaps}, "
          f"ADD to GT {before.round(3)} -> {after.round(4)} mm")
    if camera_only:
        assert (after < 8.0).all() and (after < before / 2).all(), after
    else:
        assert (after < 0.5).all(), after


def test_sharded_solve_matches_jax():
    """``solve_pose_graph_sharded`` over 2 gloo ranks (2 objects each)
    against JAX's shard_map solve on 2 virtual CPU devices, and both
    against JAX's full-mode ``solve_pose_graph`` in float64 (the same
    steps: without padded slots the guards do not act)."""
    from scflow_tpu.parallel import make_mesh
    from scflow_tpu.parallel.pose_graph import \
        solve_pose_graph_sharded as jax_sharded

    s = point_scene(seed=1)
    keys = ("points", "target_2d", "rotations", "translations", "k",
            "weights")
    inputs = {k: s[k] for k in keys}
    want = jax_sharded(*(jnp.asarray(v) for v in inputs.values()),
                       mesh=make_mesh(jax.devices()[:2]), iterations=5)
    from scflow_torch.parallel.mesh import spawn

    with ranks.one_thread_each():
        parts = spawn(ranks.sharded_solve, 2, (inputs,))
    got = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    witness = jax_solve_witness(inputs, iterations=5, camera_only=False)
    gaps = hold_to_jax(got, want, witness)
    print(f"solve_pose_graph_sharded: {gaps}")
    assert np.abs(got["translations"] - s["gt_t"]).max() < 1.0
    assert np.abs(got["rotations"] - s["gt_r"]).max() < 1e-3


NUM_CLASS, CROP, ITERS, BUDGET, IMAGES = 4, 64, 2, 4, 6


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from scflow_torch.tools.make_synthetic_bop import main

    out = tmp_path_factory.mktemp("bop")
    counts = main(["--out", str(out), "--num-images", str(IMAGES),
                   "--num-classes", str(NUM_CLASS), "--height", "160",
                   "--width", "160", "--min-objects", "1", "--max-objects",
                   "3", "--seed", "7", "--camera-angle-std", "0.02",
                   "--camera-trans-std", "5", "--device", "cpu"])
    return out, counts


def _setup(package: str, out, variables=None):
    """(trainer, builder, metric factory, mesh points) of one package on
    the tree, as the eval CLIs build them."""
    import importlib

    bop = importlib.import_module(f"{package}.data.bop")
    loader = importlib.import_module(f"{package}.data.loader")
    metrics = importlib.import_module(f"{package}.metrics")
    rendering = importlib.import_module(f"{package}.rendering")
    training = importlib.import_module(f"{package}.training")
    trainer_mod = importlib.import_module(f"{package}.training.trainer")
    cfg = training.Config()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, num_class=NUM_CLASS,
                                       iters=ITERS, test_iters=ITERS),
        data=dataclasses.replace(cfg.data, image_scale=CROP))
    kw = {}
    if package == "scflow_torch":
        cfg.render.image_size = (CROP, CROP)
        bank = rendering.load_mesh_dir(str(out / "models"), device="cpu")
        renderer = rendering.Renderer(bank, image_size=(CROP, CROP))
        kw = dict(device="cpu")
    else:
        cfg.data.native_crop = "on"
        bank = rendering.load_mesh_dir(str(out / "models"))
        renderer = rendering.Renderer(bank, image_size=(CROP, CROP),
                                      rasterizer="pallas")
        kw = dict(use_mesh=False)
    points = training.build_points_bank(bank, num_points=1000)
    trainer = trainer_mod.Trainer(cfg, renderer, points, **kw)
    mesh_points = [np.asarray(points.points[c]) for c in range(NUM_CLASS)]
    builder = loader.TestBatchBuilder(bop.RefineDataset(
        str(out / "test"), str(out / "init_poses"),
        str(out / "image_lists" / "test.txt"),
        class_names=training.YCBV_CLASS_NAMES), cfg, mesh_points)

    def metric():
        return metrics.ADDMetric(points_per_class=mesh_points,
                                 diameters=np.asarray(points.diameters),
                                 class_names=training.YCBV_CLASS_NAMES)

    return trainer, builder, metric, mesh_points


MODES = {"plain": None, "pose_graph": True, "pose_graph_full": False}


@pytest.fixture(scope="module")
def slice_runs(tree):
    """Both packages' evaluate_dataset on the tree, with the port's seeded
    weights and ``perturb``'s noise: once with a camera-only pose-graph
    metric beside the plain one, once with a full-mode one."""
    from scflow_torch.training.evaluate import evaluate_dataset
    from scflow_torch.weights import load_jax_variables, to_jax_variables
    from scflow_tpu.training.evaluate import \
        evaluate_dataset as jax_evaluate_dataset
    from scflow_tpu.training.steps import TrainState

    out, counts = tree
    trainer, builder, metric, mesh_points = _setup("scflow_torch", out)
    variables = perturb(to_jax_variables(trainer.model))
    load_jax_variables(trainer.model, variables)
    jtrainer, jbuilder, jmetric, _ = _setup("scflow_tpu", out)
    jtrainer.state = TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=jtrainer.tx.init(variables["params"]))
    got, want = {}, {}
    for camera_only, name in ((True, "pose_graph"),
                              (False, "pose_graph_full")):
        for fn, t, b, m, runs in (
                (evaluate_dataset, trainer, builder, metric, got),
                (jax_evaluate_dataset, jtrainer, jbuilder, jmetric, want)):
            plain, graph = m(), m()
            fn(t, b, plain, slot_budget=BUDGET, progress_every=0,
               pose_graph_metric=graph, pose_graph_camera_only=camera_only)
            runs.setdefault("plain", plain)
            runs[name] = graph
    return dict(got=got, want=want, mesh_points=mesh_points, counts=counts,
                trainer=trainer, builder=builder)


@pytest.mark.parametrize("which", list(MODES))
def test_eval_slice_matches_jax(slice_runs, which):
    """Per GT object, the port's ADD and ADD-S against JAX's, plain and
    after the pose graph in both modes: the same matches, errors apart by
    at most the eval's pose bounds carried through
    (test_torch_port_bop_eval.py), and the pose graph changed some
    error."""
    got = slice_runs["got"][which]._records
    want = slice_runs["want"][which]._records
    assert len(got) == len(want) == slice_runs["counts"]["objects"]
    worst = widest = 0.0
    for g, w in zip(got, want):
        assert (g["label"], g["matched"]) == (w["label"], w["matched"])
        radius = np.linalg.norm(slice_runs["mesh_points"][w["label"]],
                                axis=-1).max()
        bound = 3 * ROT_ATOL * radius + 3 * (TRANS_ATOL + TRANS_RTOL * 1200)
        widest = max(widest, bound)
        for key in ("add", "adds"):
            assert np.isfinite(g[key])
            assert abs(g[key] - w[key]) <= bound, (key, g[key], w[key])
            worst = max(worst, abs(g[key] - w[key]) / bound)
    plain = np.array([r["add"] for r in slice_runs["got"]["plain"]._records])
    for mode in ("pose_graph", "pose_graph_full"):
        refined = np.array([r["add"]
                            for r in slice_runs["got"][mode]._records])
        assert (plain != refined).any()
        print(f"{which}: worst ADD(-S) gap {worst:.3f} of its bound (at "
              f"most {widest:.3f} mm); {mode} moves ADD by up to "
              f"{np.abs(refined - plain).max():.3f} mm")


def test_pose_graph_pass_makes_no_tensor_from_host_values(slice_runs):
    """The eval loop's pose-graph pass on a packed batch already on its
    device makes no tensor from host values (its index rows go up through
    ``_to_device``), and gives the same poses as without the guard."""
    from scflow_torch.training.evaluate import (EVAL_KEYS, _pose_graph_refine,
                                                pack_eval_batches)

    trainer, builder = slice_runs["trainer"], slice_runs["builder"]
    batch, metas = next(pack_eval_batches(
        (builder[i] for i in range(len(builder))), BUDGET))
    assert any(n >= 2 for _, _, n in metas)
    out = trainer.predict({k: batch[k] for k in EVAL_KEYS},
                          keys=("rotations", "translations", "flow", "masks",
                                "depth", "ref_rotations", "ref_translations"),
                          sync=False)
    want = _pose_graph_refine(out, batch, metas, BUDGET, trainer.device)
    with _no_host_tensors():
        got = _pose_graph_refine(out, batch, metas, BUDGET, trainer.device)
    for k in want:
        assert torch.equal(got[k], want[k]), k
