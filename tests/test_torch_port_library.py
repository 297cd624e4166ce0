"""The library functions of the PyTorch port that no train or eval path
reaches, against the JAX package: rotations and SE(3) helpers, bilinear
sampling, the flow filters, the warps, local correlation and the
rotation-only point-matching loss. The same seeded numpy inputs go to
both; f32 to atol/rtol 1e-5 unless a test says why it needs more."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_common import one_torch_thread, random_rotations  # noqa: F401
from scflow_torch import geometry as tg
from scflow_torch import losses as tl
from scflow_torch.models.corr import local_correlation
from scflow_torch.ops.rasterize_fast import rasterize_fast
from scflow_torch.rendering import Renderer, make_test_meshes
from scflow_torch.utils import backward_warp, forward_warp_splat
from scflow_tpu import geometry as jg
from scflow_tpu import losses as jl
from scflow_tpu.models.corr import local_correlation as j_local_correlation
from scflow_tpu.utils import warp as jwarp

TOL = dict(atol=1e-5, rtol=1e-5)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def t(x):
    return torch.from_numpy(np.asarray(x))


def axis_angle_rotations(angles_deg, rng):
    """Rotations of the given angles about seeded random axes."""
    axis = rng.normal(size=(len(angles_deg), 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    aa = (axis * np.deg2rad(np.asarray(angles_deg))[:, None]).astype(np.float32)
    return np.asarray(jg.axis_angle_to_matrix(jnp.asarray(aa)))


@pytest.fixture(scope="module")
def rotations():
    """Near-identity through 180°, about random axes and each coordinate
    axis: every pivot of Shepperd's method is the largest somewhere."""
    rng = np.random.default_rng(0)
    angles = [0.0, 1e-4, 0.5, 10.0, 45.0, 90.0, 135.0, 170.0, 179.9, 180.0]
    r = [axis_angle_rotations(angles, rng), random_rotations(rng, 16)]
    for ax in np.eye(3, dtype=np.float32):
        for deg in (179.0, 180.0):
            aa = (ax * np.deg2rad(deg))[None].astype(np.float32)
            r.append(np.asarray(jg.axis_angle_to_matrix(jnp.asarray(aa))))
    return np.concatenate(r).astype(np.float32)


def test_pivots_cover_every_branch(rotations):
    m = rotations
    tr = m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]
    pivots = np.stack([1 + tr, 1 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2],
                       1 - m[:, 0, 0] + m[:, 1, 1] - m[:, 2, 2],
                       1 - m[:, 0, 0] - m[:, 1, 1] + m[:, 2, 2]], -1)
    assert set(pivots.argmax(-1)) == {0, 1, 2, 3}


def test_matrix_to_quaternion(rotations):
    got = tg.matrix_to_quaternion(t(rotations))
    close(got, jg.matrix_to_quaternion(jnp.asarray(rotations)))
    # and it is the rotation's quaternion
    close(tg.quaternion_to_matrix(got), rotations, atol=2e-6, rtol=0)


def test_matrix_to_ortho6d_axis_angle(rotations):
    close(tg.matrix_to_ortho6d(t(rotations)),
          jg.matrix_to_ortho6d(jnp.asarray(rotations)))
    got = tg.matrix_to_axis_angle(t(rotations))
    want = np.asarray(jg.matrix_to_axis_angle(jnp.asarray(rotations)))
    # at 180° the axis and its negation are one rotation: compare the sign
    # JAX chose, within 1e-5 rad, and the matrices everywhere
    close(got, want)
    close(tg.axis_angle_to_matrix(got), rotations, atol=2e-6, rtol=0)


def test_rotation_angle_and_pose_errors(rotations):
    rng = np.random.default_rng(1)
    r2 = random_rotations(rng, len(rotations))
    t1 = rng.uniform(-50, 50, (len(rotations), 3)).astype(np.float32)
    t2 = rng.uniform(-50, 50, (len(rotations), 3)).astype(np.float32)
    # arccos near 0 and 180° turns 1e-7 of cosine into ~0.03°: hold the
    # angles to the spread of the cosine, which both compute in f32
    got = tg.rotation_angle_deg(t(rotations), t(r2))
    want = jg.rotation_angle_deg(jnp.asarray(rotations), jnp.asarray(r2))
    close(got, want, atol=1e-3, rtol=1e-5)
    close(tg.rotation_angle_deg(t(rotations), t(rotations)),
          jg.rotation_angle_deg(jnp.asarray(rotations),
                                jnp.asarray(rotations)), atol=0.05, rtol=0)
    ang, dist = tg.pose_error(t(rotations), t(t1), t(r2), t(t2))
    j_ang, j_dist = jg.pose_error(*map(jnp.asarray, (rotations, t1, r2, t2)))
    close(ang, j_ang, atol=1e-3, rtol=1e-5)
    close(dist, j_dist)
    close(tg.translation_error(t(t1), t(t2)),
          jg.translation_error(jnp.asarray(t1), jnp.asarray(t2)))


def test_invert_and_relative_pose(rotations):
    rng = np.random.default_rng(2)
    r2 = random_rotations(rng, len(rotations))
    t1 = rng.uniform(-300, 900, (len(rotations), 3)).astype(np.float32)
    t2 = rng.uniform(-300, 900, (len(rotations), 3)).astype(np.float32)
    for got, want in zip(tg.invert_pose(t(rotations), t(t1)),
                         jg.invert_pose(jnp.asarray(rotations),
                                        jnp.asarray(t1))):
        close(got, want, atol=1e-4, rtol=1e-5)   # |t| to 900 mm: f32 ulp 6e-5
    for got, want in zip(
            tg.relative_pose(t(rotations), t(t1), t(r2), t(t2)),
            jg.relative_pose(*map(jnp.asarray, (rotations, t1, r2, t2)))):
        close(got, want, atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("padding_zero", [True, False])
def test_bilinear_sample(padding_zero):
    """(N, H, W, C) in JAX, (N, C, H, W) in the port; points inside, on
    the edges and outside the frame."""
    rng = np.random.default_rng(3)
    img = rng.normal(size=(2, 9, 11, 3)).astype(np.float32)
    pts = np.concatenate([rng.uniform(-3, 13, (2, 60, 2)),
                          np.array([[[0, 0], [10, 8], [10, 0], [-1, 4],
                                     [10.5, 8.5], [11, 9], [-0.5, -0.5],
                                     [5, 8.999]]] * 2)], 1).astype(np.float32)
    got = tg.bilinear_sample(t(img).permute(0, 3, 1, 2), t(pts),
                             padding_zero=padding_zero)
    want = jg.bilinear_sample(jnp.asarray(img), jnp.asarray(pts),
                              padding_zero=padding_zero)
    close(got.permute(0, 2, 1), want)
    # one (C, H, W) image, as JAX's 3-D form
    got1 = tg.bilinear_sample(t(img[0]).permute(2, 0, 1), t(pts[0]),
                              padding_zero=padding_zero)
    close(got1.T, jg.bilinear_sample(jnp.asarray(img[0]), jnp.asarray(pts[0]),
                                     padding_zero=padding_zero))


def test_coords_from_flow():
    flow = np.random.default_rng(4).normal(size=(2, 5, 7, 2)).astype(np.float32)
    close(tg.coords_from_flow(t(flow)), jg.coords_from_flow(jnp.asarray(flow)))


@pytest.fixture(scope="module")
def renders():
    """Two renders of 3 objects by the port's renderer on the CPU, the
    target 3° and (2, -1, 8) mm from the source: depths, face ids and the
    pose-induced flow between them."""
    bank = make_test_meshes(2, subdivisions=2, radius=40.0, device="cpu")
    h = w = 64
    renderer = Renderer(bank, image_size=(h, w), render_image=False)
    rng = np.random.default_rng(5)
    n = 3
    r_src = random_rotations(rng, n)
    t_src = np.array([[0, 0, 420.0], [5, -4, 500.0], [-6, 3, 380.0]],
                     np.float32)
    r_tgt = np.einsum("nij,njk->nik", axis_angle_rotations([3.0] * n, rng),
                      r_src).astype(np.float32)
    t_tgt = (t_src + np.array([2.0, -1.0, 8.0], np.float32))
    k = np.tile(np.array([[300.0, 0, 32], [0, 300.0, 32], [0, 0, 1]],
                         np.float32), (n, 1, 1))
    labels = torch.tensor([0, 1, 0])
    out = {}
    for tag, r, tr in (("src", r_src, t_src), ("tgt", r_tgt, t_tgt)):
        inp = renderer.rasterizer_inputs(t(r), t(tr), t(k), labels)
        frag = rasterize_fast(inp["tri_xy"], inp["tri_z"], inp["face_valid"],
                              h, w, tri_attrs=None, return_bary=False)
        out[f"depth_{tag}"] = frag["zbuf"].numpy()
        out[f"face_{tag}"] = frag["face_id"].numpy()
    flow = tg.flow_from_pose_and_depth(t(r_src), t(t_src), t(r_tgt), t(t_tgt),
                                       t(out["depth_src"]), t(k)).numpy()
    return dict(out, r_src=r_src, t_src=t_src, r_tgt=r_tgt, t_tgt=t_tgt, k=k,
                flow=flow)


def test_filter_flow_by_depth(renders):
    d = renders
    args = (d["flow"], d["depth_src"], d["depth_tgt"], d["k"], d["r_src"],
            d["t_src"], d["r_tgt"], d["t_tgt"])
    got = tg.filter_flow_by_depth(*map(t, args))
    want = np.asarray(jg.filter_flow_by_depth(*map(jnp.asarray, args)))
    kept = want[..., 0] != jg.DEFAULT_INVALID_FLOW
    assert 0 < kept.sum() < (d["depth_src"] > 0).sum()  # keeps and drops
    close(got, want)
    # a tighter threshold drops more, identically
    got2 = tg.filter_flow_by_depth(*map(t, args), consistency_thr=0.005)
    close(got2, jg.filter_flow_by_depth(*map(jnp.asarray, args),
                                        consistency_thr=0.005))


def test_filter_flow_by_face_index(renders):
    d = renders
    got = tg.filter_flow_by_face_index(t(d["flow"]), t(d["face_src"]),
                                       t(d["face_tgt"]))
    want = np.asarray(jg.filter_flow_by_face_index(
        jnp.asarray(d["flow"]), jnp.asarray(d["face_src"]),
        jnp.asarray(d["face_tgt"])))
    kept = want[..., 0] != jg.DEFAULT_INVALID_FLOW
    assert 0 < kept.sum() < (d["face_src"] >= 0).sum()
    close(got, want)


def colliding_flow(rng, n, h, w):
    """A flow that sends blocks of source pixels onto one target pixel
    (many collisions), some pixels out of the frame, the rest random."""
    flow = rng.uniform(-3, 3, (n, h, w, 2)).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    # every pixel of the left half lands on (x // 2, y // 2)
    flow[:, :, :w // 2, 0] = (xs // 2 - xs)[:, :w // 2]
    flow[:, :, :w // 2, 1] = (ys // 2 - ys)[:, :w // 2]
    flow[:, 0, :, 0] = -100.0           # the first row leaves the frame
    return flow


def test_backward_warp():
    rng = np.random.default_rng(6)
    img = rng.normal(size=(2, 10, 12, 3)).astype(np.float32)
    flow = colliding_flow(rng, 2, 10, 12)
    out, mask = backward_warp(t(img).permute(0, 3, 1, 2), t(flow),
                              return_mask=True)
    j_out, j_mask = jwarp.backward_warp(jnp.asarray(img), jnp.asarray(flow),
                                        return_mask=True)
    close(out.permute(0, 2, 3, 1), j_out)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    close(backward_warp(t(img).permute(0, 3, 1, 2), t(flow)), out)


@pytest.mark.parametrize("masked", [False, True])
def test_forward_warp_splat(masked):
    """Colliding splats: the port's winner is the largest row-major source
    index, which is also JAX's on the CPU (its scatter writes in order)."""
    rng = np.random.default_rng(7)
    img = rng.normal(size=(2, 10, 12, 3)).astype(np.float32)
    flow = colliding_flow(rng, 2, 10, 12)
    mask = (rng.uniform(size=(2, 10, 12)) > 0.3).astype(np.float32)
    m = mask if masked else None
    got = forward_warp_splat(t(img).permute(0, 3, 1, 2), t(flow),
                             None if m is None else t(m))
    want = jwarp.forward_warp_splat(jnp.asarray(img), jnp.asarray(flow),
                                    None if m is None else jnp.asarray(m))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("normalize", [True, False])
def test_local_correlation(normalize):
    rng = np.random.default_rng(8)
    f1 = rng.normal(size=(2, 9, 10, 16)).astype(np.float32)
    f2 = rng.normal(size=(2, 9, 10, 16)).astype(np.float32)
    got = local_correlation(t(f1).permute(0, 3, 1, 2),
                            t(f2).permute(0, 3, 1, 2), 4, normalize)
    want = j_local_correlation(jnp.asarray(f1), jnp.asarray(f2), 4, normalize)
    assert got.shape == (2, 81, 9, 10)
    close(got.permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_rot_point_matching_loss(loss_type):
    """Two symmetric and two asymmetric samples; the last point of each
    sample invalid."""
    rng = np.random.default_rng(9)
    n, p = 4, 40
    pred_r, gt_r = random_rotations(rng, n), random_rotations(rng, n)
    points = rng.uniform(-50, 50, (n, p, 3)).astype(np.float32)
    valid = np.ones((n, p), bool)
    valid[:, -3:] = False
    symmetric = np.array([True, False, True, False])
    diameters = rng.uniform(80, 150, n).astype(np.float32)
    args = (pred_r, gt_r, points, valid, symmetric, diameters)
    got = tl.rot_point_matching_loss(*map(t, args), loss_type=loss_type)
    want = jl.rot_point_matching_loss(*map(jnp.asarray, args),
                                      loss_type=loss_type)
    close(got, want)
