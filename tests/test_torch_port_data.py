"""The port's eval data path against the JAX package's, on the CPU: the PNG
decoder against cv2, the mesh readers and ``load_mesh_dir``, the BOP
readers, the C++-semantics crop and the batch builder, batch packing, the
ADD(-S) metric and the BOP writer, and the synthetic-BOP tool.

The JAX side reads images through its C++ library or cv2 (both here); the
port through its stdlib PNG decoder. Trees: the JAX tool's and the port's
(160², 3 classes, 4 images), each written once per module.
"""
import json
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
TREE = dict(images=4, classes=3, side=160)
CROP = 64


# -- PNG -------------------------------------------------------------------

def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(img: np.ndarray, filt, idats: int = 1, color=None,
               depth: int = 8, interlace: int = 0) -> bytes:
    """A PNG of ``img`` whose rows use filter ``filt`` (0-4) or, with
    ``'mixed'``, filter ``row % 5``; the zlib stream split over ``idats``
    IDAT chunks."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 2: 4, 3: 2, 4: 6}[bpp] if color is None else color
    px = img.reshape(h, w * bpp).astype(np.int64)
    prev = np.zeros(w * bpp, np.int64)
    rows = []
    for y in range(h):
        f = y % 5 if filt == "mixed" else filt
        cur = px[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = {0: 0, 1: left, 2: prev, 3: (left + prev) // 2,
                4: _paeth(left, prev, upleft)}[f]
        rows.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur
    z = np.frombuffer(zlib.compress(b"".join(rows)), np.uint8)
    parts = np.array_split(z, idats)
    header = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + b"".join(_chunk(b"IDAT", p.tobytes()) for p in parts)
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
def test_png_decoder_matches_cv2(tmp_path, channels, filt):
    """Gray, gray+alpha, RGB and RGBA at an odd width (37×53), every
    filter type, the stream over 3 IDATs: ``imread`` equals cv2's color
    read bit for bit (and, for gray, its gray read)."""
    from scflow_torch.data.imageio import imread

    rng = np.random.default_rng(channels * 10 + (5 if filt == "mixed" else filt))
    shape = (37, 53) if channels == 1 else (37, 53, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "img.png")
    with open(path, "wb") as f:
        f.write(encode_png(img, filt, idats=3))
    got = imread(path)
    assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])
    if channels in (1, 2):
        np.testing.assert_array_equal(imread(path, gray=True),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def test_png_decoder_reads_cv2_files(tmp_path):
    """PNGs written by cv2 (its adaptive filters, 640×480 and a mask)."""
    from scflow_torch.data.imageio import imread

    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:480, 0:640]
    img = np.stack([(x * 0.4 + y * 0.1) % 256, (y * 0.5) % 256,
                    (x * y * 0.001) % 256], -1).astype(np.uint8)
    img[100:200, 100:300] = rng.integers(0, 256, (100, 200, 3))
    cv2.imwrite(str(tmp_path / "rgb.png"), img[..., ::-1])
    cv2.imwrite(str(tmp_path / "mask.png"), (img[..., 0] > 100) * np.uint8(255))
    np.testing.assert_array_equal(imread(str(tmp_path / "rgb.png")), img)
    np.testing.assert_array_equal(imread(str(tmp_path / "mask.png"), gray=True),
                                  cv2.imread(str(tmp_path / "mask.png"),
                                             cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("case", ["jpeg", "interlaced", "palette", "16bit",
                                  "color_as_gray"])
def test_unreadable_images_raise(tmp_path, case):
    """A CMYK JPEG and interlaced, palette and 16-bit PNGs raise a
    ValueError that names the file, from ``imread`` and from
    ``check_readable``. A color PNG read as gray is read since JPEG came
    in, with cv2's libpng rule: equal to cv2's gray read."""
    from PIL import Image

    from scflow_torch.data.imageio import check_readable, imread

    img = np.random.default_rng(0).integers(0, 256, (8, 9, 3), np.uint8)
    path = str(tmp_path / f"{case}.png")
    if case == "jpeg":
        path = str(tmp_path / "img.jpg")
        Image.fromarray(img).convert("CMYK").save(path, quality=90)
    else:
        data = {"interlaced": lambda: encode_png(img, 0, interlace=1),
                "palette": lambda: encode_png(img[..., 0], 0, color=3),
                "16bit": lambda: encode_png(img, 0, depth=16),
                "color_as_gray": lambda: encode_png(img, 0)}[case]()
        with open(path, "wb") as f:
            f.write(data)
    if case == "color_as_gray":
        check_readable(path)
        np.testing.assert_array_equal(imread(path, gray=True),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE))
        return
    for read in (imread, check_readable):
        with pytest.raises(ValueError, match=Path(path).name):
            read(path)


# -- meshes -----------------------------------------------------------------

def _mesh(rng):
    from scflow_torch.rendering import icosphere

    v, f = icosphere(subdivisions=1, radius=40.0)
    return v, f, rng.random((len(v), 3)).astype(np.float32)


def _write_binary_ply(path, verts, faces, colors, uv=None):
    props = [("x", "f4"), ("y", "f4"), ("z", "f4"), ("red", "u1"),
             ("green", "u1"), ("blue", "u1")]
    if uv is not None:
        props += [("texture_u", "f4"), ("texture_v", "f4")]
    head = ["ply", "format binary_little_endian 1.0",
            f"element vertex {len(verts)}"]
    head += [f"property {'float' if t == 'f4' else 'uchar'} {n}"
             for n, t in props]
    head += [f"element face {len(faces)}",
             "property list uchar int vertex_indices", "end_header"]
    rows = np.zeros(len(verts), [(n, "<" + t) for n, t in props])
    for i, n in enumerate("xyz"):
        rows[n] = verts[:, i]
    for i, n in enumerate(("red", "green", "blue")):
        rows[n] = (colors[:, i] * 255).astype(np.uint8)
    if uv is not None:
        rows["texture_u"], rows["texture_v"] = uv[:, 0], uv[:, 1]
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        f.write(rows.tobytes())
        for face in faces:       # a quad every 7th face: fan-triangulated
            idx = list(face) + ([face[0]] if face[0] % 7 == 0 else [])
            f.write(struct.pack("<B", len(idx)) + struct.pack(f"<{len(idx)}i", *idx))


def _equal_mesh_dicts(got, want):
    assert set(got) == set(want)
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", ["ascii", "binary", "binary_uv_texture"])
def test_load_ply_matches_jax(tmp_path, kind):
    """ASCII PLY (the tools' writer), binary little-endian PLY with a quad
    face, and with UVs and a same-name PNG texture: the same arrays."""
    from scflow_tpu.rendering import meshio as jmeshio
    from scflow_torch.rendering import meshio
    from scflow_torch.tools.make_synthetic_bop import write_ply

    rng = np.random.default_rng(1)
    v, f, c = _mesh(rng)
    path = str(tmp_path / "obj_000001.ply")
    if kind == "ascii":
        write_ply(path, v, f, c)
    else:
        uv = rng.random((len(v), 2)).astype(np.float32)
        _write_binary_ply(path, v, f, c, uv if kind.endswith("texture") else None)
        if kind.endswith("texture"):
            tex = rng.integers(0, 256, (16, 24, 3), np.uint8)
            cv2.imwrite(str(tmp_path / "obj_000001.png"), tex[..., ::-1])
    _equal_mesh_dicts(meshio.load_ply(path), jmeshio.load_ply(path))


@pytest.mark.parametrize("material", ["kd", "texture"])
def test_load_obj_matches_jax(tmp_path, material):
    """OBJ (v, vt, f in the v/vt and v//vn forms, a quad) with an .mtl Kd
    color or a map_Kd PNG texture: the same arrays."""
    from scflow_tpu.rendering import meshio as jmeshio
    from scflow_torch.rendering import meshio

    rng = np.random.default_rng(2)
    v, f, _ = _mesh(rng)
    lines = ["mtllib mat.mtl"]
    lines += [f"v {a:.5f} {b:.5f} {c:.5f}" for a, b, c in v]
    lines += [f"vt {a:.4f} {b:.4f}" for a, b in rng.random((len(v), 2))]
    for i, (a, b, c) in enumerate(f + 1):
        lines.append(f"f {a}/{a} {b}/{b} {c}/{c}" if material == "texture"
                     or i % 2 else f"f {a}//{a} {b}//{b} {c}//{c}")
    lines.append("f 1/1 2/2 3/3 4/4")
    (tmp_path / "mesh.obj").write_text("\n".join(lines) + "\n")
    mtl = ["newmtl m", "Kd 0.2 0.4 0.6"]
    if material == "texture":
        tex = rng.integers(0, 256, (20, 12, 3), np.uint8)
        cv2.imwrite(str(tmp_path / "tex.png"), tex[..., ::-1])
        mtl.append("map_Kd tex.png")
    (tmp_path / "mat.mtl").write_text("\n".join(mtl) + "\n")
    path = str(tmp_path / "mesh.obj")
    _equal_mesh_dicts(meshio.load_obj(path), jmeshio.load_obj(path))


# -- trees ------------------------------------------------------------------

def _tool_args(out) -> list:
    return ["--out", str(out), "--num-images", str(TREE["images"]),
            "--num-classes", str(TREE["classes"]), "--height",
            str(TREE["side"]), "--width", str(TREE["side"]),
            "--max-objects", "3", "--seed", "3"]


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_bop")
    r = subprocess.run([sys.executable, str(REPO / "tools" /
                                            "make_synthetic_bop.py"),
                        *_tool_args(out)], capture_output=True, text=True,
                       cwd=str(REPO), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return out


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    from scflow_torch.tools.make_synthetic_bop import main

    out = tmp_path_factory.mktemp("port_bop")
    main(_tool_args(out) + ["--device", "cpu"])
    return out


def _datasets(tree):
    from scflow_tpu.data.bop import RefineDataset as JaxRefineDataset
    from scflow_torch.data.bop import RefineDataset
    from scflow_torch.training import YCBV_CLASS_NAMES

    args = (str(tree / "test"), str(tree / "init_poses"),
            str(tree / "image_lists" / "test.txt"))
    return (RefineDataset(*args, class_names=YCBV_CLASS_NAMES),
            JaxRefineDataset(*args, class_names=YCBV_CLASS_NAMES))


def test_load_mesh_dir_matches_jax(jax_tree):
    """The JAX tool's PLY models: the same bank, tensor for tensor."""
    from scflow_tpu.rendering import load_mesh_dir as jax_load_mesh_dir
    from scflow_torch.rendering import load_mesh_dir

    got = load_mesh_dir(str(jax_tree / "models"), device="cpu")
    want = jax_load_mesh_dir(str(jax_tree / "models"))
    assert got.num_classes == TREE["classes"]
    for name in ("verts", "faces", "face_valid", "vert_normals",
                 "vert_colors", "diameters"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_refine_dataset_matches_jax(jax_tree):
    """Every item of the JAX tool's tree (cv2-written PNGs), key for key."""
    port, jax_ds = _datasets(jax_tree)
    assert len(port) == len(jax_ds) == TREE["images"]
    for i in range(len(port)):
        got, want = port[i], jax_ds[i]
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v, k


@pytest.fixture(scope="module")
def builders(jax_tree):
    """(port builder, JAX builder with the C++ crop) at 64² crops."""
    from scflow_tpu.data.loader import TestBatchBuilder as JaxBuilder
    from scflow_tpu.training import Config as JaxConfig
    from scflow_tpu.training import DataConfig as JaxDataConfig
    from scflow_torch.data.loader import TestBatchBuilder
    from scflow_torch.rendering import load_mesh_dir
    from scflow_torch.training import Config, DataConfig, build_points_bank

    points = build_points_bank(load_mesh_dir(str(jax_tree / "models"),
                                             device="cpu"), num_points=200)
    mesh_points = list(points.points.numpy())
    port_ds, jax_ds = _datasets(jax_tree)
    port = TestBatchBuilder(port_ds, Config(data=DataConfig(image_scale=CROP)),
                            mesh_points)
    jax_b = JaxBuilder(jax_ds, JaxConfig(data=JaxDataConfig(
        image_scale=CROP, native_crop="on")), mesh_points)
    assert jax_b._native
    return port, jax_b


def test_crop_matches_native():
    """``crop_resize_pad_batch`` against the JAX package's C++ crop on a
    640×480 image: in-frame, out-of-frame and straddling boxes, boxes with
    odd ``rh``, tiny and huge ones; patches within 1e-4 on the normalised
    scale, transforms equal to 1e-6."""
    from scflow_tpu.data import native
    from scflow_torch.data.pipeline import crop_resize_pad_batch

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    x1, y1 = rng.uniform(-300, 700, 200), rng.uniform(-300, 500, 200)
    side = rng.uniform(3, 500, 200)
    boxes = np.trunc(np.stack([x1, y1, x1 + side * rng.uniform(0.4, 1.6, 200),
                               y1 + side], -1)).astype(np.float32)
    boxes = np.concatenate([boxes, [[-500, -400, -300, -200],    # off frame
                                    [600, 400, 900, 700],
                                    [10, 10, 10 + 255, 10 + 83]]]).astype(np.float32)
    odd = 0
    for size in (CROP, 256):
        want, t_want = native.crop_resize_pad_batch([img] * len(boxes), boxes,
                                                    size, mean=(10, 20, 30),
                                                    std=(50, 60, 70))
        got, t_got = crop_resize_pad_batch([img] * len(boxes), boxes, size,
                                           mean=(10, 20, 30), std=(50, 60, 70))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        np.testing.assert_allclose(t_got, t_want, rtol=0, atol=1e-6)
        hw = np.trunc(boxes[:, 2:]) - np.trunc(boxes[:, :2])
        rh = np.rint(hw[:, 1] * size / hw.max(1))
        odd += int((rh % 2 == 1).sum())
    assert odd > 50


def test_test_batch_builder_matches_jax(builders):
    """Each item of the builders: crops within 1e-4, K' and transforms
    equal to 1e-6, every other key equal."""
    port, jax_b = builders
    assert len(port) == len(jax_b)
    for i in range(len(port)):
        got, want = port[i], jax_b[i]
        assert set(got) == set(want)
        np.testing.assert_allclose(got["real_images"], want["real_images"],
                                   rtol=0, atol=1e-4)
        for k in ("k", "transform_matrix"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        for k, v in want.items():
            if k not in ("real_images", "k", "transform_matrix"):
                np.testing.assert_array_equal(np.asarray(got[k]),
                                              np.asarray(v), err_msg=k)


def test_pad_and_pack_match_jax(builders):
    """``pad_to_batch`` and ``pack_eval_batches`` (budget 4: several
    batches, an image flushed to the next) give the same arrays and slot
    maps on the same items."""
    from scflow_tpu.data.loader import pad_to_batch as jax_pad
    from scflow_tpu.training.evaluate import pack_eval_batches as jax_pack
    from scflow_torch.data.loader import pad_to_batch
    from scflow_torch.training.evaluate import pack_eval_batches

    port, _ = builders
    items = [port[i] for i in range(len(port))]
    for item in items:
        got, want = pad_to_batch(item, 4), jax_pad(item, 4)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got, want = list(pack_eval_batches(items, 4)), list(jax_pack(items, 4))
    assert len(got) == len(want) >= 2
    for (gb, gm), (wb, wm) in zip(got, want):
        assert set(gb) == set(wb)
        for k in wb:
            assert gb[k].dtype == wb[k].dtype
            np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)
        assert [(m[1], m[2]) for m in gm] == [(m[1], m[2]) for m in wm]


# -- metrics and writer -----------------------------------------------------

def _metric_inputs(rng):
    """Per-image (pred, gt, K): duplicate labels, a GT with no prediction,
    a prediction with no GT; classes 0 and 2 symmetric."""
    from port_common import random_rotations

    points = [rng.normal(scale=40.0, size=(60, 3)).astype(np.float32)
              for _ in range(3)]
    k = np.array([[572.4, 0, 320], [0, 572.4, 240], [0, 0, 1]], np.float32)
    images = []
    for labels_gt, labels_pred in (([0, 1, 1], [1, 0, 1]), ([2, 0], [2]),
                                   ([1], [1, 2]), ([0, 2, 2], [2, 0, 2])):
        n_gt, n_pred = len(labels_gt), len(labels_pred)
        gt_r = random_rotations(rng, n_gt)
        gt_t = np.concatenate([rng.uniform(-80, 80, (n_gt, 2)),
                               rng.uniform(600, 1000, (n_gt, 1))], 1)
        pred_r = random_rotations(rng, n_pred)
        pred_t = (np.resize(gt_t, (n_pred, 3))
                  + rng.normal(scale=8.0, size=(n_pred, 3)))
        images.append(({"labels": np.asarray(labels_pred),
                        "rotations": pred_r,
                        "translations": pred_t.astype(np.float32),
                        "scores": np.ones(n_pred, np.float32)},
                       {"labels": np.asarray(labels_gt), "rotations": gt_r,
                        "translations": gt_t.astype(np.float32)}, k))
    return points, images


def test_add_metric_matches_jax():
    """``ADDMetric`` fed the same predictions: the same dict exactly
    (unmatched GT, symmetric classes, the AUC), the same records through
    ``records_arrays``/``load_arrays``, the same ``format_metric_table``."""
    from scflow_tpu.metrics import ADDMetric as JaxADDMetric
    from scflow_tpu.metrics import format_metric_table as jax_table
    from scflow_torch.metrics import ADDMetric, format_metric_table

    points, images = _metric_inputs(np.random.default_rng(4))
    kw = dict(points_per_class=points,
              diameters=np.array([150.0, 90.0, 120.0], np.float32),
              symmetric_classes=(0, 2), class_names=("a", "b", "c"))
    port, jax_m = ADDMetric(**kw), JaxADDMetric(**kw)
    for pred, gt, k in images:
        port.process(pred, gt, k=k)
        jax_m.process(pred, gt, k=k)
    got, want = port.compute(), jax_m.compute()
    assert got == want and got["num_instances"] == 9
    assert format_metric_table(got) == jax_table(want)
    arrays = port.records_arrays()
    for k, v in jax_m.records_arrays().items():
        np.testing.assert_array_equal(arrays[k], v)
    assert np.isinf(arrays["add"]).sum() == 1        # the unmatched GT
    port.load_arrays(arrays)
    assert port.compute() == want


def test_bop_writer_matches_jax(tmp_path):
    """``write_bop_results``: the same files, byte for byte."""
    from scflow_tpu.metrics import write_bop_results as jax_write
    from scflow_torch.metrics import write_bop_results

    _, images = _metric_inputs(np.random.default_rng(5))
    results = [{"scene_id": 1 + i % 2, "img_id": i, **pred}
               for i, (pred, _, _) in enumerate(images)]
    got = write_bop_results(results, str(tmp_path / "port"))
    want = jax_write(results, str(tmp_path / "jax"))
    assert [Path(p).relative_to(tmp_path / "port") for p in got] == [
        Path(p).relative_to(tmp_path / "jax") for p in want]
    assert len(got) == 2
    for a, b in zip(got, want):
        assert Path(a).read_bytes() == Path(b).read_bytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jitter_pose_np_matches_jax(seed):
    """``jitter_pose_np`` with mesh points and the ADD limit: the same
    draws and poses from the same Generator state."""
    from port_common import random_rotations
    from scflow_tpu.data.pipeline import jitter_pose_np as jax_jitter
    from scflow_tpu.training.config import JitterConfig as JaxJitter
    from scflow_torch.data.pipeline import jitter_pose_np
    from scflow_torch.training import JitterConfig

    r = random_rotations(np.random.default_rng(seed), 1)[0]
    t = np.array([10.0, -20.0, 800.0], np.float32)
    pts = np.random.default_rng(seed).normal(scale=50, size=(40, 3))
    kw = dict(angle_std_deg=30.0, add_limit=0.3)
    got = jitter_pose_np(np.random.default_rng(seed), r, t,
                         JitterConfig(**kw), pts, 150.0)
    want = jax_jitter(np.random.default_rng(seed), r, t, JaxJitter(**kw),
                      pts, 150.0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_make_synthetic_bop_matches_jax(jax_tree, port_tree):
    """The port's tool and the JAX tool with one seed: equal JSON poses,
    cameras and image list, byte-equal PLYs; RGB images and masks equal on
    ≥ 99% of pixels (the JAX renderer runs another rasterizer on the CPU,
    so silhouette edges may differ); ``scene_gt_info.json`` equal up to the
    pixels where the masks differ."""
    from scflow_torch.data.imageio import imread

    seq = Path("test") / "000001"
    for rel in (seq / "scene_gt.json", seq / "scene_camera.json",
                Path("init_poses") / "000001" / "scene_gt.json"):
        assert (json.loads((port_tree / rel).read_text())
                == json.loads((jax_tree / rel).read_text())), rel
    assert ((port_tree / "image_lists" / "test.txt").read_text()
            == (jax_tree / "image_lists" / "test.txt").read_text())
    plys = sorted((jax_tree / "models").glob("*.ply"))
    assert len(plys) == TREE["classes"]
    for p in plys:
        assert (port_tree / "models" / p.name).read_bytes() == p.read_bytes()
    mask_diff = {}
    for kind in ("rgb", "mask_visib"):
        files = sorted((jax_tree / seq / kind).glob("*.png"))
        assert [f.name for f in files] == sorted(
            f.name for f in (port_tree / seq / kind).glob("*.png"))
        for f in files:
            gray = kind == "mask_visib"
            got = imread(str(port_tree / seq / kind / f.name), gray=gray)
            want = cv2.imread(str(f), cv2.IMREAD_GRAYSCALE if gray
                              else cv2.IMREAD_COLOR)
            same = got == (want if gray else want[..., ::-1])
            same = same if gray else same.all(-1)
            assert same.mean() >= 0.99, f
            if gray:
                mask_diff[f.stem] = int((~same).sum())
    got = json.loads((port_tree / seq / "scene_gt_info.json").read_text())
    want = json.loads((jax_tree / seq / "scene_gt_info.json").read_text())
    assert got.keys() == want.keys()
    for img_id in want:
        for i, (g, w) in enumerate(zip(got[img_id], want[img_id],
                                       strict=True)):
            diff = mask_diff[f"{int(img_id):06d}_{i:06d}"]
            assert abs(g["px_count_visib"] - w["px_count_visib"]) <= diff
            if diff == 0:
                assert g == w


def test_prefetch_keeps_dataset_order():
    """``_prefetch_items`` with more workers than items in flight and
    reads that finish out of order yields items in dataset order, and a
    failed read raises in the consumer."""
    import time

    from scflow_torch.training.evaluate import _prefetch_items

    delays = np.random.default_rng(0).uniform(0, 0.004, 60)

    class Builder:
        def __getitem__(self, i):
            time.sleep(delays[i])
            if i == 59:
                raise KeyError(i)
            return i

    got = []
    with pytest.raises(KeyError):
        for item in _prefetch_items(Builder(), range(60), depth=8,
                                    workers=16):
            got.append(item)
    assert got == list(range(59))
