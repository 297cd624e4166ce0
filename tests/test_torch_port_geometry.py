"""Geometry of the PyTorch port against the JAX package: rotations,
delta-pose composition, projection, dense correspondences and
pose-induced flow. The same seeded numpy inputs go to both; atol/rtol
1e-5 (both sides compute in f32, in different summation orders)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_common import random_rotations
from scflow_torch import geometry as tg
from scflow_tpu.geometry import flow as jflow
from scflow_tpu.geometry import projection as jproj
from scflow_tpu.geometry import rotation as jrot
from scflow_tpu.geometry import se3 as jse3

TOL = dict(atol=1e-5, rtol=1e-5)
K = np.array([[500.0, 0.0, 32.0], [0.0, 480.0, 30.0], [0.0, 0.0, 1.0]],
             np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def poses(rng, n):
    t = np.concatenate([rng.uniform(-30, 30, (n, 2)),
                        rng.uniform(500, 900, (n, 1))], -1).astype(np.float32)
    return random_rotations(rng, n), t


def depth_map(rng, n, h=12, w=16):
    d = rng.uniform(400, 800, (n, h, w)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.3] = 0.0
    return d


def test_normalize():
    v = np.random.default_rng(0).normal(size=(5, 7, 3)).astype(np.float32)
    v[0, 0] = 0.0
    close(tg.normalize(torch.from_numpy(v)), jrot.normalize(jnp.asarray(v)))


@pytest.mark.parametrize("fn", ["ortho6d_to_matrix", "quaternion_to_matrix"])
def test_rotation_reps(fn):
    dim = 6 if fn == "ortho6d_to_matrix" else 4
    x = np.random.default_rng(1).normal(size=(8, dim)).astype(np.float32)
    close(getattr(tg, fn)(torch.from_numpy(x)),
          getattr(jrot, fn)(jnp.asarray(x)))


@pytest.mark.parametrize("rot_dim", [6, 4])
@pytest.mark.parametrize("depth_transform", ["exp", "linear"])
def test_compose_delta_pose(rot_dim, depth_transform):
    rng = np.random.default_rng(2)
    r, t = poses(rng, 6)
    drot = rng.normal(size=(6, rot_dim)).astype(np.float32)
    dtrans = (0.1 * rng.normal(size=(6, 3))).astype(np.float32)
    got = tg.compose_delta_pose(
        *map(torch.from_numpy, (drot, dtrans, r, t)),
        depth_transform=depth_transform, detach_depth_for_xy=True)
    want = jse3.compose_delta_pose(
        *map(jnp.asarray, (drot, dtrans, r, t)),
        depth_transform=depth_transform, detach_depth_for_xy=True)
    for g, w in zip(got, want):
        close(g, w)


def test_project_points():
    rng = np.random.default_rng(3)
    r, t = poses(rng, 3)
    pts = rng.uniform(-60, 60, (3, 50, 3)).astype(np.float32)
    k = np.tile(K, (3, 1, 1))
    got = tg.project_points(*map(torch.from_numpy, (pts, k, r, t)))
    want = jproj.project_points(*map(jnp.asarray, (pts, k, r, t)))
    for g, w in zip(got, want):
        close(g, w)


def test_pixel_grid():
    close(tg.pixel_grid(5, 7), jproj.pixel_grid(5, 7), atol=0, rtol=0)


@pytest.mark.parametrize("with_pose", [False, True])
def test_unproject_depth(with_pose):
    rng = np.random.default_rng(4)
    r, t = poses(rng, 2)
    d = depth_map(rng, 2)
    k = np.tile(K, (2, 1, 1))
    pose_t = (torch.from_numpy(r), torch.from_numpy(t)) if with_pose else ()
    pose_j = (jnp.asarray(r), jnp.asarray(t)) if with_pose else ()
    got = tg.unproject_depth(torch.from_numpy(d), torch.from_numpy(k), *pose_t)
    want = jproj.unproject_depth(jnp.asarray(d), jnp.asarray(k), *pose_j)
    for g, w in zip(got if with_pose else [got], want if with_pose else [want]):
        close(g, w)


def test_depth_to_correspondences():
    rng = np.random.default_rng(5)
    r, t = poses(rng, 2)
    d = depth_map(rng, 2)
    k = np.tile(K, (2, 1, 1))
    got = tg.depth_to_correspondences(*map(torch.from_numpy, (d, k, r, t)))
    want = jproj.depth_to_correspondences(*map(jnp.asarray, (d, k, r, t)))
    close(got[0], want[0], atol=0, rtol=0)
    close(got[1], want[1])
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("invalid_num", [0.0, 400.0])
def test_flow_from_pose_and_points(invalid_num):
    rng = np.random.default_rng(6)
    r, t = poses(rng, 2)
    r2, t2 = poses(rng, 2)
    d = depth_map(rng, 2)
    k = np.tile(K, (2, 1, 1))
    _, pts, valid = jproj.depth_to_correspondences(
        *map(jnp.asarray, (d, k, r, t)))
    pts, valid = np.array(pts), np.array(valid)
    got = tg.flow_from_pose_and_points(
        *map(torch.from_numpy, (r2, t2, k, pts, valid)),
        invalid_num=invalid_num)
    want = jflow.flow_from_pose_and_points(
        *map(jnp.asarray, (r2, t2, k, pts, valid)), invalid_num=invalid_num)
    close(got, want)


def test_transform_points():
    rng = np.random.default_rng(7)
    r, t = poses(rng, 3)
    pts = rng.uniform(-60, 60, (3, 40, 3)).astype(np.float32)
    close(tg.transform_points(*map(torch.from_numpy, (r, t, pts))),
          jse3.transform_points(*map(jnp.asarray, (r, t, pts))))


def test_axis_angle_to_matrix():
    aa = np.random.default_rng(8).normal(size=(6, 3)).astype(np.float32)
    aa[0] = 0.0                                    # angle 0: the identity
    aa[1] = (1e-9, 0.0, 0.0)                       # below the 1e-8 floor
    got = tg.axis_angle_to_matrix(torch.from_numpy(aa))
    close(got, jrot.axis_angle_to_matrix(jnp.asarray(aa)))
    assert torch.equal(got[:2], torch.eye(3).expand(2, 3, 3))


@pytest.mark.parametrize("invalid_num", [0.0, 400.0])
def test_flow_from_pose_and_depth(invalid_num):
    rng = np.random.default_rng(9)
    r, t = poses(rng, 2)
    r2, t2 = poses(rng, 2)
    d = depth_map(rng, 2)
    k = np.tile(K, (2, 1, 1))
    got = tg.flow_from_pose_and_depth(
        *map(torch.from_numpy, (r, t, r2, t2, d, k)), invalid_num=invalid_num)
    want = jflow.flow_from_pose_and_depth(
        *map(jnp.asarray, (r, t, r2, t2, d, k)), invalid_num=invalid_num)
    close(got, want, atol=1e-4, rtol=1e-5)   # flows of ~100 px: f32 steps


@pytest.mark.parametrize("seed", [10, 11])
def test_filter_flow_by_mask(seed):
    """Bilinear mask samples at (p + flow)·W/(W−1) − 0.5, zero outside the
    frame. The kept set must agree exactly, except where the sample lies
    within 1e-5 of the 0.9 threshold (f32 products in another order); such
    pixels are counted and reported, and must be few."""
    rng = np.random.default_rng(seed)
    h, w = 24, 32
    mask = np.zeros((3, h, w), np.float32)
    mask[:, 5:19, 6:26] = 1.0
    mask[1, 8:12, 10:14] = 0.0                     # a hole
    mask[2] = rng.uniform(size=(h, w)) > 0.3
    flow = (rng.normal(size=(3, h, w, 2)) * 6.0).astype(np.float32)
    flow[:, :4] += np.float32(-40.0)               # out of frame: dropped
    flow[0, 10, :] = np.round(flow[0, 10, :])      # integer taps too
    got = tg.filter_flow_by_mask(torch.from_numpy(flow),
                                 torch.from_numpy(mask)).numpy()
    want = np.asarray(jflow.filter_flow_by_mask(jnp.asarray(flow),
                                                jnp.asarray(mask)))
    grid = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)
    tgt = grid + flow.astype(np.float64)
    sampled = np.asarray(jflow._grid_sample_zeros(
        jnp.asarray(mask),
        jnp.asarray((tgt[..., 0] * w / (w - 1) - 0.5).astype(np.float32)),
        jnp.asarray((tgt[..., 1] * h / (h - 1) - 0.5).astype(np.float32))))
    near = np.abs(sampled - 0.9) < 1e-5
    kept_got, kept_want = got[..., 0] != 400.0, want[..., 0] != 400.0
    differ = kept_got != kept_want
    print(f"filter_flow_by_mask seed {seed}: {int(near.sum())} pixels within "
          f"1e-5 of the threshold, {int(differ.sum())} differ")
    assert not (differ & ~near).any()
    assert near.sum() <= 0.01 * near.size
    assert kept_want.any() and (~kept_want).any()
    assert (~kept_want[:, :4]).all()               # out of frame: dropped
    np.testing.assert_array_equal(got[kept_got & kept_want],
                                  want[kept_got & kept_want])


@pytest.mark.parametrize("std", [(15.0, 15.0, 50.0), (60.0, 150.0, 300.0)],
                         ids=["default", "clipped"])
def test_jitter_core_with_jax_normals(std):
    """The port's deterministic jitter core fed the normals that the JAX
    ``jitter_pose`` draws from its key. The wide setting clips angles at
    45° and shrinks offsets onto 200 mm."""
    import jax

    from scflow_torch.data.synthetic import jitter_pose_core
    from scflow_torch.training import JitterConfig
    from scflow_tpu.data.synthetic import jitter_pose
    from scflow_tpu.training import JitterConfig as JJitterConfig

    rng = np.random.default_rng(12)
    r, t = poses(rng, 8)
    key = jax.random.PRNGKey(5)
    k1, k2, k3 = jax.random.split(key, 3)
    normals = [np.array(jax.random.normal(k1, (8, 3))),
               np.array(jax.random.normal(k2, (8,))),
               np.array(jax.random.normal(k3, (8, 3)))]
    fields = dict(zip(("angle_std_deg", "xy_std_mm", "z_std_mm"), std))
    want = jitter_pose(key, jnp.asarray(r), jnp.asarray(t),
                       JJitterConfig(**fields))
    got = jitter_pose_core(torch.from_numpy(r), torch.from_numpy(t),
                           *map(torch.from_numpy, normals),
                           JitterConfig(**fields))
    close(got[0], want[0])
    close(got[1], want[1], atol=1e-4, rtol=1e-6)     # translations of ~700 mm
