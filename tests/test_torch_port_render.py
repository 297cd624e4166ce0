"""Rendering of the PyTorch port (kernel K1's module) against the JAX package.

The tile rasterizer's plain path (``scflow_torch.ops.rasterize_fast``)
takes the same projected faces as JAX ``rasterize_fast(interpret=True)``;
the port's ``Renderer`` takes the same poses as JAX
``Renderer(rasterizer="pallas")``. Bounds, where both cover:

- face-id/mask mismatch at most 0.2% of pixels, the bound of the JAX
  package's own rasterizer test (0 is measured);
- zbuf/depth within 1e-3 + 2·s per pixel, where s = u·Σₖ |ztₖ|(|aₖx| +
  |bₖy| + |cₖ|) is the f32 rounding scale of evaluating the winning face's
  coefficient row at the pixel (u = 2⁻²⁴). The coefficient tables agree
  bit for bit, but the edge functions cancel terms far larger than their
  result, so no pixel of these scenes has s below ~5e-4 mm (median ~2e-3
  mm, up to 0.13 mm on ~1 px² faces). The float64 witness holds both
  sides to it: each is within s of the same row evaluated in float64 (the
  port at ≤ 0.60 s, JAX at ≤ 0.94 s), the port at least as close as JAX,
  so the two differ by at most 2·s (measured ≤ 1.31 s);
- attributes within 2e-4 of each channel's range, where the face ids agree;
- images within 1e-4 (measured 4.4e-5)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_common import random_rotations
from scflow_torch.ops import rasterize_fast as trf
from scflow_torch.rendering import Renderer as TorchRenderer
from scflow_torch.rendering import make_test_meshes as torch_meshes
from scflow_tpu.geometry import random_rotation
from scflow_tpu.rendering import Renderer as JaxRenderer
from scflow_tpu.rendering import make_test_meshes as jax_meshes
from scflow_tpu.rendering.rasterizer import project_vertices

# the package re-exports the function under the module's name
jrf = importlib.import_module("scflow_tpu.ops.rasterize_fast")

H, W = 64, 128
K = jnp.asarray([[300.0, 0.0, 64.0], [0.0, 300.0, 32.0], [0.0, 0.0, 1.0]])
U = 2.0 ** -24        # f32 unit roundoff


def float64_witness(coeff: torch.Tensor, face_id: np.ndarray):
    """Per pixel, from the (N, F, 16) coefficient table and the (N, H, W)
    winning face ids: z of the winning face's row evaluated in float64, and
    the f32 rounding scale u·Σₖ |ztₖ|(|aₖx| + |bₖy| + |cₖ|) of that sum."""
    c = coeff.double().numpy()
    n, h, w = face_id.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    row = c[np.arange(n)[:, None, None], np.clip(face_id, 0, None)]
    z = scale = 0.0
    for k in range(3):
        a, b, cc, zt = (row[..., 3 * k], row[..., 3 * k + 1],
                        row[..., 3 * k + 2], row[..., 9 + k])
        z = z + (a * xs + b * ys + cc) * zt
        scale = scale + (np.abs(a * xs) + np.abs(b * ys) + np.abs(cc)) * np.abs(zt)
    return z, U * scale


def check_depth(got, want, z64, scale, where):
    """The float64 witness and the port-vs-JAX depth bound (module doc)."""
    got, want, z64, scale = (np.asarray(v, np.float64)[where]
                             for v in (got, want, z64, scale))
    port_err = np.abs(got - z64) / scale
    jax_err = np.abs(want - z64) / scale
    assert port_err.max() <= 1.0 and jax_err.max() <= 1.0, (
        port_err.max(), jax_err.max())
    assert port_err.max() <= jax_err.max(), (port_err.max(), jax_err.max())
    np.testing.assert_array_less(np.abs(got - want), 1e-3 + 2.0 * scale)


def test_mesh_bank_and_tri_tables_equal():
    jb = jax_meshes(num_classes=3, subdivisions=2, radius=60.0).with_tri_tables()
    tb = torch_meshes(num_classes=3, subdivisions=2, radius=60.0,
                      device="cpu").with_tri_tables()
    for name in ("verts", "faces", "face_valid", "vert_normals",
                 "vert_colors", "diameters", "tri_pos", "tri_attr"):
        want = np.asarray(getattr(jb, name))
        got = getattr(tb, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=name)


def scene(label, seed, subdivisions=2, z=600.0):
    bank = jax_meshes(num_classes=2, subdivisions=subdivisions,
                      radius=60.0).with_tri_tables()
    r = random_rotation(jax.random.PRNGKey(seed), ())
    xy, zv = project_vertices(bank.verts[label], r, jnp.asarray([0., 0., z]), K)
    faces = np.asarray(bank.faces[label])
    tri_xy = np.asarray(xy)[faces]
    tri_z = np.asarray(zv)[faces]
    return (tri_xy, tri_z, np.array(bank.face_valid[label]),
            np.array(bank.tri_attr[label]), faces)


def both(tri_xy, tri_z, fvalid, attrs, faces, k_faces=jrf.K_FACES):
    want = jrf.rasterize_fast(None, None, jnp.asarray(faces),
                              jnp.asarray(fvalid), H, W,
                              tri_attrs=jnp.asarray(attrs), k_faces=k_faces,
                              interpret=True, return_bary=False,
                              tri_xy=jnp.asarray(tri_xy),
                              tri_z=jnp.asarray(tri_z))
    got = trf.rasterize_fast(
        torch.from_numpy(tri_xy)[None], torch.from_numpy(tri_z)[None],
        torch.from_numpy(fvalid)[None], H, W,
        tri_attrs=torch.from_numpy(attrs)[None], k_faces=k_faces)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v[0].numpy() for k, v in got.items()})


@pytest.mark.parametrize("label,seed,k_faces,subdivisions,drop", [
    (0, 0, 256, 2, 0), (0, 1, 256, 2, 0), (0, 2, 64, 2, 0), (1, 5, 256, 2, 0),
    (0, 3, 256, 2, 3), (0, 4, 256, 4, 0), (0, 6, 64, 3, 0)],
    ids=["sphere0", "sphere1", "sphere-k64", "box",
         # 317 faces: the last chunk is padded
         "faces-not-multiple-of-8",
         # 5120 faces: the kernel's binning scans more than one block of chunks
         "sphere-sub4",
         # 1280 faces, 64 slots: the overlapping chunks are cut to 8
         "sphere-sub3-k64"])
def test_plain_tile_pass_matches_jax(label, seed, k_faces, subdivisions, drop):
    tri_xy, tri_z, fvalid, attrs, faces = (
        v[:len(v) - drop] for v in scene(label, seed, subdivisions))
    want, got = both(tri_xy, tri_z, fvalid, attrs, faces, k_faces=k_faces)
    fid_w, fid_g = want["face_id"], got["face_id"]
    assert (fid_w >= 0).any()
    assert (fid_w != fid_g).mean() <= 0.002
    same = (fid_w == fid_g) & (fid_w >= 0)
    coeff, _, _ = trf._coeff_table(*(torch.from_numpy(v)[None]
                                     for v in (tri_xy, tri_z, fvalid)))
    z64, scale = float64_witness(coeff, fid_g[None])
    check_depth(got["zbuf"], want["zbuf"], z64[0], scale[0], same)
    scale = np.abs(want["attrs"][same]).max(axis=0)          # per channel
    np.testing.assert_allclose(got["attrs"][same] / scale,
                               want["attrs"][same] / scale, atol=2e-4)
    bg = fid_g < 0
    assert (got["zbuf"][bg] == 0).all() and (got["attrs"][bg] == 0).all()


def test_tile_selection_matches_jax():
    # a K of 64 truncates the overlapping chunks: the same first chunks win
    tri_xy, tri_z, fvalid, _, _ = scene(0, 1)
    coeff_j, bbox_j, ok_j = jrf._coeff_table(jnp.asarray(tri_xy),
                                             jnp.asarray(tri_z),
                                             jnp.asarray(fvalid))
    sel_j, _ = jrf._select_tiles(coeff_j, bbox_j, ok_j, H, W, 64)
    coeff, bbox, ok = trf._coeff_table(torch.from_numpy(tri_xy)[None],
                                       torch.from_numpy(tri_z)[None],
                                       torch.from_numpy(fvalid)[None])
    sel = trf._select_tiles(bbox, ok, H, W, 64)[0].long()      # (T, K)
    rows = torch.where((sel >= 0)[..., None], coeff[0][sel.clamp_min(0)], 0.0)
    np.testing.assert_array_equal(rows.transpose(1, 2).numpy(),
                                  np.asarray(sel_j))
    np.testing.assert_array_equal(coeff[0].numpy(), np.asarray(coeff_j))


def test_all_invalid_mesh_is_empty():
    tri_xy, tri_z, fvalid, attrs, _ = scene(0, 0)
    out = trf.rasterize_fast(
        torch.from_numpy(tri_xy)[None], torch.from_numpy(tri_z)[None],
        torch.zeros(1, fvalid.shape[0], dtype=torch.bool), H, W,
        tri_attrs=torch.from_numpy(attrs)[None])
    assert (out["face_id"] == -1).all()
    assert (out["zbuf"] == 0).all() and (out["attrs"] == 0).all()


@pytest.mark.parametrize("shader,separate_lights", [
    ("phong", True), ("phong", False), ("gouraud", True), ("flat", True)])
def test_renderer_matches_jax(shader, separate_lights):
    rng = np.random.default_rng(7)
    n = 3
    r = random_rotations(rng, n)
    t = np.concatenate([rng.uniform(-20, 20, (n, 2)),
                        rng.uniform(600, 800, (n, 1))], -1).astype(np.float32)
    k = np.tile(np.array([[500.0, 0, 32], [0, 500.0, 32], [0, 0, 1]],
                         np.float32), (n, 1, 1))
    labels = np.arange(n, dtype=np.int32)
    opts = dict(image_size=(64, 64), shader_type=shader,
                separate_lights=separate_lights)
    jr = JaxRenderer(jax_meshes(3, subdivisions=2, radius=20.0),
                     rasterizer="pallas", **opts)
    want = jax.tree.map(np.asarray, jr(*map(jnp.asarray, (r, t, k, labels))))
    tr = TorchRenderer(torch_meshes(3, subdivisions=2, radius=20.0,
                                    device="cpu"), **opts)
    args = (*map(torch.from_numpy, (r, t, k)), torch.from_numpy(labels).long())
    got = {key: v.numpy() for key, v in tr(*args).items()}
    assert want["mask"].any()
    assert (want["mask"] != got["mask"]).mean() <= 0.002
    both_cover = want["mask"] & got["mask"]
    inp = tr.rasterizer_inputs(*args)
    coeff, _, _, _, _ = trf.tile_inputs(inp["tri_xy"], inp["tri_z"],
                                        inp["face_valid"], 64, 64,
                                        inp["tri_attrs"])
    face_id = trf.rasterize_fast(inp["tri_xy"], inp["tri_z"],
                                 inp["face_valid"], 64, 64,
                                 tri_attrs=inp["tri_attrs"])["face_id"]
    z64, scale = float64_witness(coeff, face_id.numpy())
    check_depth(got["depth"], want["depth"], z64, scale, both_cover)
    np.testing.assert_allclose(got["images"][both_cover],
                               want["images"][both_cover], atol=1e-4)
    np.testing.assert_array_equal(got["images"][~got["mask"]],
                                  want["images"][~want["mask"]])
