"""The port's other rasterizers, K1's no-attribute form, the silhouette and
the renderer's options, against the JAX package on the CPU.

``scflow_torch.rendering.rasterizer`` (``project_vertices``, the dense
``rasterize``, ``rasterize_binned``, ``interpolate_face_attributes``)
takes the same projected meshes as ``scflow_tpu.rendering.rasterizer``;
the tile pass without attributes (the plain version of K1's no-attribute
form) takes the faces JAX ``rasterize_fast(tri_attrs=None)`` takes in
interpret mode; ``silhouette_alpha`` the same fragments; the ``Renderer``
the same poses under each option. Bounds (those of
``test_torch_port_render.py``):

- face ids and masks exact (the packed keys hold the face id; measured:
  no pixel differs);
- z within 1e-3 + 2·s per pixel, s the f32 rounding scale of the winning
  face's coefficient row at the pixel (``float64_witness``);
- attributes within 2e-4 of each channel's range, images within 1e-4,
  where the face ids agree;
- barycentrics within 1e-4 + 4·s/z: each is an edge function over the
  face's area, cancelling terms of the size the depth's s measures;
- soft silhouettes within 1e-4 (a sigmoid of squared distances scaled by
  (2/64)²/1e-4 ≈ 9.8 per pixel², measured ≤ 1e-5).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_common import random_rotations
from port_common import one_torch_thread  # noqa: F401 (autouse)
from scflow_torch.ops import rasterize_fast as trf
from scflow_torch.rendering import Renderer as TorchRenderer
from scflow_torch.rendering import make_test_meshes as torch_meshes
from scflow_torch.rendering import rasterizer as trast
from scflow_torch.rendering.shading import silhouette_alpha
from scflow_tpu.geometry import random_rotation
from scflow_tpu.rendering import Renderer as JaxRenderer
from scflow_tpu.rendering import make_test_meshes as jax_meshes
from scflow_tpu.rendering import rasterizer as jrast
from scflow_tpu.rendering import shading as jshading
from test_torch_port_render import float64_witness

jrf = importlib.import_module("scflow_tpu.ops.rasterize_fast")

H, W = 64, 128
K = np.array([[300.0, 0.0, 64.0], [0.0, 300.0, 32.0], [0.0, 0.0, 1.0]],
             np.float32)
N = 3


@pytest.fixture(scope="module")
def scenes():
    """N projected meshes (two icospheres and a box, 1280 / 12 faces padded
    to 1280, every face kept: both windings rasterize) in numpy."""
    bank = jax_meshes(num_classes=3, subdivisions=3, radius=60.0
                      ).with_tri_tables()
    out = {k: [] for k in ("verts", "r", "t", "xy", "z", "faces", "valid",
                           "attrs")}
    for i in range(N):
        label = i % 3
        r = random_rotation(jax.random.PRNGKey(10 + i), ())
        t = jnp.asarray([8.0 * i - 8.0, 4.0, 600.0 + 50.0 * i])
        xy, z = jrast.project_vertices(bank.verts[label], r, t,
                                       jnp.asarray(K))
        for key, v in (("verts", bank.verts[label]), ("r", r), ("t", t),
                       ("xy", xy), ("z", z), ("faces", bank.faces[label]),
                       ("valid", bank.face_valid[label]),
                       ("attrs", bank.tri_attr[label])):
            out[key].append(np.asarray(v))
    return {k: np.stack(v) for k, v in out.items()}


def tensors(scenes, *keys):
    return [torch.from_numpy(scenes[k]) for k in keys]


def witness_scale(scenes, face_id):
    """s of the module doc at each pixel of the (N, H, W) face ids."""
    xy, z, faces, valid = tensors(scenes, "xy", "z", "faces", "valid")
    rows = torch.arange(N)[:, None, None]
    coeff, _, _ = trf._coeff_table(xy[rows, faces.long()],
                                   z[rows, faces.long()], valid)
    return float64_witness(coeff, face_id)[1]


def jax_each(fn, scenes, *keys, **kw):
    """JAX's single-mesh ``fn`` over the N meshes, stacked as numpy."""
    outs = [fn(*(jnp.asarray(scenes[k][i]) for k in keys), **kw)
            for i in range(N)]
    return {k: np.stack([np.asarray(o[k]) for o in outs]) for k in outs[0]}


def check_fragments(got, want, scale, attrs=True):
    fid_g, fid_w = got["face_id"], want["face_id"]
    assert (fid_w >= 0).any() and (fid_w < 0).any()
    np.testing.assert_array_equal(fid_g, fid_w)
    cover = fid_w >= 0
    np.testing.assert_array_less(
        np.abs(got["zbuf"] - want["zbuf"])[cover], 1e-3 + 2.0 * scale[cover])
    assert (got["zbuf"][~cover] == 0).all()
    if "bary" in want:
        bound = 1e-4 + 4.0 * scale / np.maximum(np.abs(want["zbuf"]), 1.0)
        np.testing.assert_array_less(
            np.abs(got["bary"] - want["bary"]).max(-1)[cover], bound[cover])
        assert (got["bary"][~cover] == 0).all()
    if attrs and "attrs" in want:
        span = np.abs(want["attrs"][cover]).max(axis=0)
        np.testing.assert_allclose(got["attrs"][cover] / span,
                                   want["attrs"][cover] / span, atol=2e-4)
        assert (got["attrs"][~cover] == 0).all()


def test_project_vertices_matches_jax(scenes):
    verts, r, t = tensors(scenes, "verts", "r", "t")
    xy, z = trast.project_vertices(verts, r, t,
                                   torch.from_numpy(K).expand(N, 3, 3))
    np.testing.assert_allclose(xy.numpy(), scenes["xy"], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(z.numpy(), scenes["z"], rtol=1e-6)


def test_scan_rasterizer_matches_jax(scenes):
    # 1280 faces in chunks of 384: the last chunk is padded
    chunk = 384
    want = jax_each(jrast.rasterize, scenes, "xy", "z", "faces", "valid",
                    height=H, width=W, chunk=chunk)
    got = trast.rasterize(*tensors(scenes, "xy", "z", "faces", "valid"), H, W,
                          chunk=chunk)
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want) == {"zbuf", "face_id", "bary"}
    check_fragments(got, want, witness_scale(scenes, got["face_id"]))


@pytest.mark.parametrize("k_faces,attrs,bary", [
    (256, True, True), (64, True, False), (60, False, True)],
    ids=["k256-attrs-bary", "k64-attrs", "k60-top-k-bary"])
def test_binned_rasterizer_matches_jax(scenes, k_faces, attrs, bary):
    # k 60 is not a multiple of 8: faces are picked one by one (top_k)
    tri_attrs = scenes["attrs"] if attrs else None
    outs = [jrast.rasterize_binned(
        *(jnp.asarray(scenes[k][i]) for k in ("xy", "z", "faces", "valid")),
        H, W, k_faces=k_faces, return_bary=bary,
        tri_attrs=None if tri_attrs is None else jnp.asarray(tri_attrs[i]))
        for i in range(N)]
    want = {k: np.stack([np.asarray(o[k]) for o in outs]) for k in outs[0]}
    got = trast.rasterize_binned(
        *tensors(scenes, "xy", "z", "faces", "valid"), H, W, k_faces=k_faces,
        return_bary=bary,
        tri_attrs=None if tri_attrs is None else torch.from_numpy(tri_attrs))
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    if not bary:
        assert (got["bary"] == 0).all() and (want["bary"] == 0).all()
    check_fragments(got, want, witness_scale(scenes, got["face_id"]))


def test_interpolate_face_attributes_matches_jax(scenes):
    frag = jax_each(jrast.rasterize, scenes, "xy", "z", "faces", "valid",
                    height=H, width=W)
    vert_attrs = np.concatenate([scenes["verts"], scenes["xy"]], -1)
    want = np.stack([np.asarray(jrast.interpolate_face_attributes(
        jnp.asarray(frag["face_id"][i]), jnp.asarray(frag["bary"][i]),
        jnp.asarray(scenes["faces"][i]), jnp.asarray(vert_attrs[i])))
        for i in range(N)])
    got = trast.interpolate_face_attributes(
        torch.from_numpy(frag["face_id"]), torch.from_numpy(frag["bary"]),
        torch.from_numpy(scenes["faces"]), torch.from_numpy(vert_attrs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    assert (got.numpy()[frag["face_id"] < 0] == 0).all()


@pytest.mark.parametrize("k_faces", [256, 64])
def test_tile_pass_without_attributes_matches_jax(scenes, k_faces):
    """The plain version of K1's no-attribute form against JAX's Pallas
    kernel with ``d_attr=0`` in interpret mode, and the ``return_bary``
    tail behind both."""
    rows = np.arange(N)[:, None, None]
    tri_xy = scenes["xy"][rows, scenes["faces"]]
    tri_z = scenes["z"][rows, scenes["faces"]]
    outs = [jrf.rasterize_fast(
        None, None, jnp.asarray(scenes["faces"][i]),
        jnp.asarray(scenes["valid"][i]), H, W, tri_attrs=None,
        k_faces=k_faces, interpret=True, return_bary=True,
        tri_xy=jnp.asarray(tri_xy[i]), tri_z=jnp.asarray(tri_z[i]))
        for i in range(N)]
    want = {k: np.stack([np.asarray(o[k]) for o in outs]) for k in outs[0]}
    got = trf.rasterize_fast(torch.from_numpy(tri_xy), torch.from_numpy(tri_z),
                             torch.from_numpy(scenes["valid"]), H, W,
                             k_faces=k_faces)
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want) == {"zbuf", "face_id", "bary"}
    check_fragments(got, want, witness_scale(scenes, got["face_id"]))


def test_tile_pass_without_attributes_equals_the_attribute_pass(scenes):
    """Face ids and z of the two forms of the plain tile pass are the same
    bits, and the no-attribute form returns an empty attribute tensor."""
    rows = torch.arange(N)[:, None, None]
    xy, z, faces, valid, attrs = tensors(scenes, "xy", "z", "faces", "valid",
                                         "attrs")
    tri_xy, tri_z = xy[rows, faces.long()], z[rows, faces.long()]
    coeff, bbox, attr, d, k = trf.tile_inputs(tri_xy, tri_z, valid, H, W,
                                              attrs)
    bare = trf.tile_inputs(tri_xy, tri_z, valid, H, W, None)
    assert bare[2] is None and bare[3] == 0
    full = trf.rasterize_tiles_reference(coeff, bbox, attr, H, W, d, k)
    none = trf.rasterize_tiles(*bare[:2], None, H, W, 0, bare[4])
    assert none[2].shape == (N, H, W, 0)
    for a, b in zip(full[:2], none[:2]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    with pytest.raises(ValueError):
        trf.rasterize_tiles(coeff, bbox, None, H, W, d, k)
    with pytest.raises(ValueError):
        trf.rasterize_tiles(coeff, bbox, attr, H, W, 0, k)


@pytest.mark.parametrize("soft", [True, False], ids=["soft", "hard"])
def test_silhouette_alpha_matches_jax(scenes, soft):
    frag = jax_each(jrast.rasterize, scenes, "xy", "z", "faces", "valid",
                    height=H, width=W)
    rows = np.arange(N)[:, None, None]
    tri_xy = scenes["xy"][rows, scenes["faces"]]
    want = np.stack([np.asarray(jshading.silhouette_alpha(
        jnp.asarray(frag["face_id"][i]), jnp.asarray(tri_xy[i]), (H, W),
        sigma=1e-4, soft=soft)) for i in range(N)])
    got = silhouette_alpha(torch.from_numpy(frag["face_id"]),
                           torch.from_numpy(tri_xy), (H, W), sigma=1e-4,
                           soft=soft).numpy()
    assert got.dtype == np.float32
    if not soft:
        np.testing.assert_array_equal(got, want)
        return
    cover = frag["face_id"] >= 0
    assert (want[cover] < 1).any() and (want[cover] >= 0.5).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (got[~cover] == 0).all()


def renderer_inputs(n=3, seed=7):
    rng = np.random.default_rng(seed)
    r = random_rotations(rng, n)
    t = np.concatenate([rng.uniform(-20, 20, (n, 2)),
                        rng.uniform(600, 800, (n, 1))], -1).astype(np.float32)
    k = np.tile(np.array([[500.0, 0, 32], [0, 500.0, 32], [0, 0, 1]],
                         np.float32), (n, 1, 1))
    return r, t, k, np.arange(n, dtype=np.int32) % 3


# (port rasterizer, JAX rasterizer, shader, cull, image, mask, soft)
RENDER_MODES = [
    ("scan", "scan", "phong", True, True, False, False),
    ("binned", "binned", "gouraud", False, True, True, False),
    ("pallas", "pallas", "phong", True, False, True, True),
    ("auto", "auto", "flat", True, True, True, True),
    ("scan", "scan", "flat", False, False, True, True),
]


@pytest.mark.parametrize(
    "mode", RENDER_MODES,
    ids=["scan-phong", "binned-gouraud-nocull-hardmask",
         "pallas-depth-only-softmask", "auto-flat-softmask",
         "scan-nocull-depth-only-softmask"])
def test_renderer_options_match_jax(mode):
    """Each option against JAX's ``Renderer``. 'auto' is the tile path in
    the port and the binned XLA path in JAX on the CPU: both give the same
    face ids, so the same masks."""
    ours, theirs, shader, cull, image, mask, soft = mode
    r, t, k, labels = renderer_inputs()
    opts = dict(image_size=(64, 64), shader_type=shader, cull_backfaces=cull,
                render_image=image, render_mask=mask, soft_blending=soft)
    jr = JaxRenderer(jax_meshes(3, subdivisions=2, radius=20.0),
                     rasterizer=theirs, **opts)
    want = jax.tree.map(np.asarray, jr(*map(jnp.asarray, (r, t, k, labels))))
    tr = TorchRenderer(torch_meshes(3, subdivisions=2, radius=20.0,
                                    device="cpu"), rasterizer=ours, **opts)
    args = (*map(torch.from_numpy, (r, t, k)), torch.from_numpy(labels).long())
    got = {key: v.numpy() for key, v in tr(*args).items()}
    assert set(got) == set(want)
    assert ("images" in got) == image and ("masks" in got) == mask
    assert want["mask"].any()
    np.testing.assert_array_equal(got["mask"], want["mask"])
    cover = want["mask"]
    inp = tr.rasterizer_inputs(*args)
    coeff, _, _ = trf._coeff_table(inp["tri_xy"], inp["tri_z"],
                                   inp["face_valid"])
    face_id = trf.rasterize_fast(inp["tri_xy"], inp["tri_z"],
                                 inp["face_valid"], 64, 64)["face_id"]
    _, scale = float64_witness(coeff, face_id.numpy())
    np.testing.assert_array_less(np.abs(got["depth"] - want["depth"])[cover],
                                 1e-3 + 2.0 * scale[cover])
    if image:
        np.testing.assert_allclose(got["images"][cover],
                                   want["images"][cover], atol=1e-4)
        np.testing.assert_array_equal(got["images"][~cover],
                                      want["images"][~cover])
    if mask:
        assert got["masks"].dtype == np.float32
        np.testing.assert_allclose(got["masks"], want["masks"], rtol=0,
                                   atol=1e-4 if soft else 0.0)


def test_renderer_mesh_bank_override_and_refusals():
    r, t, k, labels = renderer_inputs()
    args = (*map(torch.from_numpy, (r, t, k)), torch.from_numpy(labels).long())
    small = torch_meshes(3, subdivisions=1, radius=20.0, device="cpu")
    big = torch_meshes(3, subdivisions=2, radius=25.0, device="cpu")
    want = TorchRenderer(big, image_size=(64, 64))(*args)
    got = TorchRenderer(small, image_size=(64, 64))(*args, mesh_bank=big)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    for bad in (dict(rasterizer="xla"), dict(shader_type="toon")):
        with pytest.raises(ValueError):
            TorchRenderer(small, image_size=(64, 64), **bad)
