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
