"""The port's JPEG decoder and what reads JPEG through it, on the CPU.

- ``data/jpeg.py`` (a C++ decoder built with the host's compiler) against
  ``cv2.imread`` bit for bit, color and gray, over a matrix of files that
  cv2 and PIL write here; against the JAX package's C++ library (system
  libjpeg); on the committed fixtures and their manifest; its refusals.
- ``imageio``: a color PNG read as gray against cv2 on all 2^24 colors.
- A pbr-like tree (JPEG frames, JPEG backgrounds): the dataset, the batch
  builder and ``_mixpbr``'s concatenated dataset against JAX's, bit for
  bit; a ``.jpg`` mesh texture; the ``scflow_ycbv_pbr`` recipe through the
  training CLI where cv2, PIL and JAX cannot be imported.
- The host PnP of the ``keep_intrinsic`` / ``target_intrinsic`` modes
  (``pipeline.remap_pose`` and its callers) against JAX's, with cv2
  blocked on both sides and against JAX's cv2 branch.
"""
import dataclasses
import hashlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import cv2
import numpy as np
import pytest
from PIL import Image

from test_torch_port_traindata import _configs, _equal

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "torch_fixtures"
_spec = importlib.util.spec_from_file_location(
    "make_jpeg_fixtures", FIXTURES / "make_jpeg_fixtures.py")
fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures)

SIZES = [(1, 1), (7, 9), (17, 33), (483, 645)]            # (h, w)
MODES = {"baseline": {}, "progressive": dict(progressive=True),
         "optimized": dict(optimize=True), "rst1": dict(restart=1),
         "rst3": dict(restart=3)}
QUALITIES = (50, 75, 95, 100)
FRAME = (128, 160)


def _cv2(data: bytes, gray: bool) -> np.ndarray:
    flag = cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR
    img = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
    return img if gray else img[..., ::-1]


def _assert_decodes_as_cv2(data: bytes, what: str) -> None:
    from scflow_torch.data.jpeg import decode_jpeg

    for gray in (False, True):
        np.testing.assert_array_equal(decode_jpeg(data, what, gray),
                                      _cv2(data, gray),
                                      err_msg=f"{what} gray={gray}")


# -- the decoder against cv2 -------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", sorted(fixtures.SAMPLING))
def test_decoder_matches_cv2(sampling, size):
    """cv2-written files of one sampling and size, two content seeds
    (gradients, noise, flat blocks), q 50/75/95/100, baseline,
    progressive, optimised Huffman tables and restart intervals 1 and 3:
    color and gray reads bit-equal to cv2's."""
    for seed in (0, 1):
        img = fixtures.content(*size, seed)
        for q in QUALITIES:
            for mode, kw in MODES.items():
                _assert_decodes_as_cv2(
                    fixtures.encode(img, q, sampling, **kw),
                    f"{size} {sampling} q{q} {mode} seed {seed}")


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_gray_and_pil_files_match_cv2(size):
    """Gray files (baseline, progressive, restarts) and PIL's forms:
    progressive with optimised tables, 4:2:2, and Adobe RGB (no YCbCr
    transform, components 'R','G','B') at 4:2:0 and 4:4:4."""
    from scflow_torch.data.jpeg import jpeg_info

    img = fixtures.content(*size, 3)
    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    for q in (50, 95):
        for kw in ({}, dict(progressive=True), dict(restart=2)):
            _assert_decodes_as_cv2(fixtures.encode(gray, q, **kw),
                                   f"gray {size} q{q} {kw}")
    for kw in (dict(progressive=True, optimize=True), dict(subsampling=1),
               dict(keep_rgb=True), dict(keep_rgb=True, subsampling=0)):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=90, **kw)
        data = buf.getvalue()
        if kw.get("keep_rgb"):
            assert b"Adobe" in data[:64] and b"JFIF" not in data[:64]
        assert jpeg_info(data).components == 3
        _assert_decodes_as_cv2(data, f"PIL {size} {kw}")


def _manifest() -> list:
    return json.loads((FIXTURES / "jpeg" / "manifest.json").read_text())["files"]


def test_fixtures_match_manifest():
    """The committed fixtures decode to the digests of cv2's arrays that
    the manifest holds (what chip_smoke checks without cv2), and to
    cv2's arrays; the frames are BOP pbr's form."""
    from scflow_torch.data.imageio import imread
    from scflow_torch.data.jpeg import jpeg_info

    files = _manifest()
    assert {f["kind"] for f in files} == {"frame", "textured", "background",
                                         "conformance"}
    assert sum((FIXTURES / "jpeg" / f["file"]).stat().st_size
               for f in files) < 600_000
    for f in files:
        path = str(FIXTURES / "jpeg" / f["file"])
        for gray, key in ((False, "rgb_sha256"), (True, "gray_sha256")):
            img = imread(path, gray=gray)
            assert hashlib.sha256(img.tobytes()).hexdigest() == f[key], path
            flag = cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR
            want = cv2.imread(path, flag)
            np.testing.assert_array_equal(img, want if gray else want[..., ::-1])
        if f["kind"] == "frame":
            info = jpeg_info(Path(path).read_bytes(), path)
            assert (info.width, info.height, info.process) == (640, 480,
                                                               "baseline")


def test_decoder_matches_jax_native():
    """Color reads of every fixture equal the JAX package's C++ library,
    which links the system libjpeg (skipped where it cannot be loaded)."""
    from scflow_tpu.data import native
    from scflow_torch.data.imageio import imread

    if native.get_lib() is None:
        pytest.skip("the JAX package's native library does not load here")
    for f in _manifest():
        path = str(FIXTURES / "jpeg" / f["file"])
        np.testing.assert_array_equal(imread(path),
                                      native.decode_image(path, channels=3),
                                      err_msg=path)


def test_color_png_read_as_gray_matches_cv2(tmp_path):
    """Every 8-bit RGB color once, in one 4096² PNG the port's filter-0
    encoder writes, and an RGBA image: the gray read equals cv2's
    (libpng's rgb-to-gray, alpha dropped)."""
    from scflow_torch.data.imageio import imread
    from scflow_torch.utils.tb_writer import encode_png

    idx = np.arange(1 << 24, dtype=np.uint32).reshape(4096, 4096)
    rgb = np.stack([idx >> 16, (idx >> 8) & 255, idx & 255],
                   -1).astype(np.uint8)
    rgba = np.random.default_rng(0).integers(0, 256, (31, 47, 4), np.uint8)
    for name, img in (("all.png", rgb), ("rgba.png", rgba)):
        path = tmp_path / name
        path.write_bytes(encode_png(img))
        np.testing.assert_array_equal(
            imread(str(path), gray=True),
            cv2.imread(str(path), cv2.IMREAD_GRAYSCALE), err_msg=name)


def _refused_file(kind: str, path: Path) -> str:
    """A JPEG the decoder refuses; returns what the message names."""
    img = fixtures.content(24, 40, 5)
    if kind == "cmyk":
        Image.fromarray(img).convert("CMYK").save(path, quality=90)
        return "CMYK"
    data = bytearray(fixtures.encode(img, 90))
    sof = data.index(b"\xff\xc0")
    if kind == "truncated":
        path.write_bytes(bytes(data[:len(data) * 2 // 3]))
        return "truncated"
    if kind == "12bit":
        data[sof + 4] = 12
    else:
        data[sof + 1] = {"sof9": 0xC9, "sof3": 0xC3}[kind]
    path.write_bytes(bytes(data))
    return {"12bit": "12-bit", "sof9": "arithmetic", "sof3": "lossless"}[kind]


@pytest.mark.parametrize("kind", ["cmyk", "sof9", "sof3", "12bit",
                                  "truncated"])
def test_refused_jpegs_raise(tmp_path, kind):
    """A PIL CMYK file, a cv2 file patched to arithmetic coding (SOF9), to
    lossless (SOF3) and to 12-bit precision, and a truncated entropy
    stream: ``imread`` (color and gray) and ``check_readable`` raise a
    ValueError naming the file and the reason."""
    from scflow_torch.data.imageio import check_readable, imread

    path = tmp_path / f"{kind}.jpg"
    reason = _refused_file(kind, path)
    for read in (imread, lambda p: imread(p, gray=True), check_readable):
        with pytest.raises(ValueError, match=f"{kind}.jpg.*{reason}"):
            read(str(path))


# -- a pbr-like tree ---------------------------------------------------------

FRAME_FORMS = [dict(), dict(progressive=True), dict(sampling="444", restart=2),
               dict(sampling="422"), dict(quality=80), dict(sampling="411")]


def _to_jpeg(split_dir: Path, image_list: Path) -> None:
    """Re-encode a split's frames as JPEG (one form per frame), delete the
    PNGs and point the image list at the JPEGs."""
    for i, png in enumerate(sorted(split_dir.glob("*/rgb/*.png"))):
        img = cv2.imread(str(png), cv2.IMREAD_COLOR)[..., ::-1]
        png.with_suffix(".jpg").write_bytes(fixtures.encode(
            img, **FRAME_FORMS[i % len(FRAME_FORMS)]))
        png.unlink()
    image_list.write_text(image_list.read_text().replace(".png", ".jpg"))


@pytest.fixture(scope="module")
def pbr(tmp_path_factory):
    """A 6-frame JPEG ``train_pbr`` split and a 4-frame PNG ``train_real``
    split (21 classes, 128×160), 3 JPEG backgrounds (progressive, gray,
    4:4:4 with restarts), laid out as the YCB-V recipes read them."""
    from scflow_torch.tools.make_synthetic_bop import main

    root = tmp_path_factory.mktemp("pbr")
    common = ["--num-classes", "21", "--height", str(FRAME[0]), "--width",
              str(FRAME[1]), "--min-objects", "2", "--max-objects", "4",
              "--device", "cpu"]
    main(["--out", str(root / "pbr"), "--split", "train_pbr",
          "--num-images", "6", "--seed", "0", *common])
    main(["--out", str(root / "real"), "--split", "train_real",
          "--num-images", "4", "--seed", "1", *common])
    _to_jpeg(root / "pbr" / "train_pbr",
             root / "pbr" / "image_lists" / "train_pbr.txt")
    bg = root / "coco"
    bg.mkdir()
    img = fixtures.content(72, 96, 9, noise=6.0)
    (bg / "a.jpg").write_bytes(fixtures.encode(img, progressive=True))
    (bg / "b.jpg").write_bytes(fixtures.encode(
        cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)))
    (bg / "c.jpg").write_bytes(fixtures.encode(img[::-1], sampling="444",
                                               restart=3))
    data = root / "layout" / "data"
    ycbv = data / "ycbv"
    (ycbv / "image_lists").mkdir(parents=True)
    for tree, split in ((root / "pbr", "train_pbr"),
                        (root / "real", "train_real")):
        os.symlink(tree / split, ycbv / split)
        os.symlink(tree / "image_lists" / f"{split}.txt",
                   ycbv / "image_lists" / f"{split}.txt")
    os.symlink(root / "pbr" / "models", ycbv / "models_1024")
    os.symlink(bg, data / "coco")
    return root


@pytest.fixture(scope="module")
def pbr_meshes(pbr):
    from scflow_torch.rendering import load_mesh_dir
    from scflow_torch.training import build_points_bank

    bank = load_mesh_dir(str(pbr / "pbr" / "models"), device="cpu")
    points = build_points_bank(bank, num_points=512)
    return list(points.points.numpy()), list(points.diameters.numpy())


def _pbr_dataset(pbr, jax=False):
    from scflow_torch.training import YCBV_CLASS_NAMES

    if jax:
        from scflow_tpu.data.bop import SuperviseTrainDataset
    else:
        from scflow_torch.data.bop import SuperviseTrainDataset
    return SuperviseTrainDataset(
        str(pbr / "pbr" / "train_pbr"),
        str(pbr / "pbr" / "image_lists" / "train_pbr.txt"),
        class_names=YCBV_CLASS_NAMES, min_visib_fract=0.2, seed=5)


def _all_augs(pbr) -> dict:
    return dict(color_aug=True, background_dir=str(pbr / "coco"),
                background_p=0.5, occlusion_p=0.5, occlusion_v2_p=0.5)


def test_pbr_dataset_matches_jax(pbr):
    """Every JPEG frame through ``get`` with a caller's Generator: the
    items (frames decoded by the port, by JAX's C++ library or cv2) and
    the draws are equal."""
    port, jax = _pbr_dataset(pbr), _pbr_dataset(pbr, jax=True)
    assert len(port) == len(jax) == 6
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    for i in range(len(port)):
        item = port.get(i, rng)
        _equal(item, jax.get(i, jrng), f"get {i}")
        assert item is None or item["img_path"].endswith(".jpg")
    assert rng.bit_generator.state == jrng.bit_generator.state


@pytest.mark.parametrize("seed", [0, 1])
def test_pbr_builder_matches_jax(pbr, pbr_meshes, seed):
    """3 batches of 4 objects from the JPEG frames with every augmentation
    on (color, JPEG backgrounds, noise and object-paste occlusion):
    bit-equal to JAX's, with the same draws."""
    from scflow_tpu.data.loader import TrainBatchBuilder as JaxBuilder
    from scflow_torch.data.loader import TrainBatchBuilder

    cfg, jcfg = _configs(**_all_augs(pbr))
    b = TrainBatchBuilder(_pbr_dataset(pbr), cfg, *pbr_meshes, seed=seed)
    jb = JaxBuilder(_pbr_dataset(pbr, jax=True), jcfg, *pbr_meshes, seed=seed)
    assert len(b._bg_paths) == 3
    for i in range(3):
        _equal(b(), jb(), f"batch {i}")
    assert b.rng.bit_generator.state == jb.rng.bit_generator.state


def _jax_concat_get(self, index, rng=None):
    """The port's ``ConcatDataset.get`` on JAX's class (which lacks it)."""
    i = int(np.searchsorted(self._offsets, index, side="right")) - 1
    return self.datasets[i].get(index - int(self._offsets[i]), rng)


@pytest.mark.parametrize("seed", [0, 1])
def test_mixpbr_dataset_matches_jax(pbr, pbr_meshes, seed, monkeypatch):
    """``configs.build_dataset`` of ``scflow_ycbv_mixpbr``'s spec over the
    PNG ``train_real`` root and the JPEG ``train_pbr`` root, with the
    recipe's backgrounds (``data/coco``) and occlusions: items and 3
    batches bit-equal to JAX's."""
    import scflow_tpu.configs as jax_configs
    from scflow_tpu.configs.build import build_dataset as jax_build_dataset
    from scflow_tpu.data.bop import ConcatDataset as JaxConcat
    from scflow_tpu.data.loader import TrainBatchBuilder as JaxBuilder
    from scflow_torch import configs
    from scflow_torch.configs.build import build_dataset
    from scflow_torch.data.loader import TrainBatchBuilder

    monkeypatch.chdir(pbr / "layout")
    monkeypatch.setattr(JaxConcat, "get", _jax_concat_get, raising=False)
    spec = configs.scflow_ycbv_mixpbr()
    jspec = jax_configs.scflow_ycbv_mixpbr()
    port = build_dataset(spec.train_data, seed=seed)
    jax = jax_build_dataset(jspec.train_data, seed=seed)
    assert len(port) == len(jax) == 10
    for i in range(len(port)):
        _equal(port[i], jax[i], f"item {i}")
    data = {f.name: getattr(spec.config.data, f.name)
            for f in dataclasses.fields(spec.config.data)
            if f.name in ("background_dir", "background_p", "occlusion_v2_p",
                          "min_visib_fract")}
    cfg, jcfg = _configs(**data)
    b = TrainBatchBuilder(port, cfg, *pbr_meshes, seed=seed)
    jb = JaxBuilder(jax, jcfg, *pbr_meshes, seed=seed)
    assert len(b._bg_paths) == 3
    for i in range(3):
        _equal(b(), jb(), f"batch {i}")
    assert b.rng.bit_generator.state == jb.rng.bit_generator.state


def test_jpg_mesh_texture_matches_cv2(tmp_path):
    """A PLY with UVs and a same-name ``.jpg`` texture: the vertex colors
    sampled from it equal the JAX reader's (cv2), and the texture reads as
    cv2 reads it."""
    from scflow_tpu.rendering.meshio import load_ply as jax_load_ply
    from scflow_torch.rendering.meshio import _read_image, load_ply
    from test_torch_port_data import _mesh, _write_binary_ply

    rng = np.random.default_rng(0)
    verts, faces, colors = _mesh(rng)
    uv = rng.random((len(verts), 2)).astype(np.float32)
    _write_binary_ply(tmp_path / "obj_000001.ply", verts, faces, colors, uv)
    tex = fixtures.content(37, 53, 2, noise=8.0)
    (tmp_path / "obj_000001.jpg").write_bytes(fixtures.encode(tex, 90))
    want = cv2.imread(str(tmp_path / "obj_000001.jpg"), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(
        _read_image(str(tmp_path / "obj_000001.jpg")),
        want[..., ::-1].astype(np.float32) / 255.0)
    got = load_ply(str(tmp_path / "obj_000001.ply"))
    ref = jax_load_ply(str(tmp_path / "obj_000001.ply"))
    np.testing.assert_array_equal(got["vert_colors"], ref["vert_colors"])


BLOCKED_PBR_RUN = """
import sys
for name in ("cv2", "PIL", "jax", "scflow_tpu"):
    sys.modules[name] = None        # any import of it now raises
import dataclasses
from scflow_torch import configs
from scflow_torch.train import main
pbr = configs.scflow_ycbv_pbr()
pbr.config.data = dataclasses.replace(
    pbr.config.data, background_dir="data/coco", background_p=1.0,
    occlusion_v2_p=1.0)
configs.RECIPES["scflow_ycbv_pbr"] = lambda: pbr
trainer = main(["--config", "scflow_ycbv_pbr", "--device", "cpu",
                "--image-size", "64", "--iters", "2", "--batch-size", "2",
                "--steps", "1", "--work-dir", sys.argv[1]])
assert trainer.step == 1
print(sorted(m for m in ("cv2", "PIL", "jax", "scflow_tpu")
             if sys.modules.get(m) is not None))
"""


def test_pbr_recipe_trains_without_cv2_pil_or_jax(pbr, tmp_path):
    """``--config scflow_ycbv_pbr`` on the JPEG split, a JPEG background
    drawn on every sample, in a process where cv2, PIL, JAX and
    scflow_tpu cannot be imported: one step, a finite loss logged."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", BLOCKED_PBR_RUN,
                        str(tmp_path / "run")], cwd=str(pbr / "layout"),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
    with open(tmp_path / "run" / "train_log.jsonl") as f:
        assert np.isfinite(json.loads(f.readline())["loss"])


# -- the host PnP of the other geometry modes ------------------------------

GEOMETRY_MODES = ["adapt_intrinsic", "keep_intrinsic", "target_intrinsic"]
PNP_TOL = dict(rotation=1e-6, translation=1e-4, rmsd=1e-6)


def _pnp_case(seed: int):
    """A pose, 64 model keypoints, a crop of a 480×640 frame and a target
    intrinsic matrix."""
    from scflow_torch.data.pipeline import crop_resize_pad

    rng = np.random.default_rng(seed)
    angle = rng.normal(size=3)
    rot, _ = cv2.Rodrigues(angle * 0.6 / np.linalg.norm(angle))
    t = np.array([25.0, -40.0, 650.0]) + rng.normal(0, 20, 3)
    pts = rng.uniform(-50, 50, (64, 3))
    k = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]])
    frame = rng.integers(0, 256, (480, 640, 3), np.uint8)
    crop = crop_resize_pad(frame, np.array([250.5, 170.2, 410.8, 300.9]), k,
                           256)
    target_k = np.array([[600.0, 0, 128.0], [0, 600.0, 128.0], [0, 0, 1]])
    return (rot.astype(np.float32), t.astype(np.float32), pts,
            k.astype(np.float32), crop, target_k.astype(np.float32))


class _Solves:
    """``_solve_pnp_np`` with seeded N(0, σ²) pixel noise on its keypoints
    (the same draws in both packages), recording each solve."""

    def __init__(self, solve, sigma: float, seed: int):
        self.solve, self.sigma, self.seed, self.calls = solve, sigma, seed, []

    def __call__(self, pts, pix, k, *args):
        rng = np.random.default_rng(self.seed)
        noisy = pix + rng.normal(0, self.sigma, pix.shape)
        r, t = self.solve(pts, noisy, k, *args)
        self.calls.append((pts, noisy, pix, np.asarray(k, np.float64), r, t))
        return r, t


def _rmsd(pts, pix, k, r, t) -> float:
    """``remap_pose``'s reprojection RMS of the float32-cast pose."""
    from scflow_torch.data.pipeline import _project

    proj = _project(pts, r.astype(np.float32), t.astype(np.float32), k)
    return float(np.sqrt(np.mean(np.sum((proj - pix) ** 2, axis=1))))


def _witness(pts, pix, k, r, t):
    """The float64 least-squares pose, from (r, t): scipy's LM over a
    rotation vector and t, run to its tolerance floor."""
    from scipy.optimize import least_squares

    from scflow_torch.data.pipeline import _project

    def residual(x):
        return (_project(pts, cv2.Rodrigues(x[:3])[0], x[3:], k) - pix).ravel()

    x0 = np.concatenate([cv2.Rodrigues(np.asarray(r, np.float64))[0].ravel(),
                         t])
    x = least_squares(residual, x0, method="lm", xtol=1e-15, ftol=1e-15,
                      gtol=1e-15, max_nfev=10000).x
    return cv2.Rodrigues(x[:3])[0], x[3:]


def _errors(solve, witness, pts, clean, k) -> np.ndarray:
    """(rotation entries, translation, rmsd) of a solve against the
    witness; the rmsd against the noise-free pixels, as ``remap_pose``
    measures it."""
    return np.array([np.abs(solve[0] - witness[0]).max(),
                     np.abs(solve[1] - witness[1]).max(),
                     abs(_rmsd(pts, clean, k, *solve)
                         - _rmsd(pts, clean, k, *witness))])


@pytest.mark.parametrize("sigma", [0.0, 0.5])
@pytest.mark.parametrize("mode", GEOMETRY_MODES)
@pytest.mark.parametrize("jax_branch", ["no_cv2", "cv2"])
def test_geometry_modes_match_jax(jax_branch, mode, sigma, monkeypatch):
    """``apply_geometry_transform_mode`` and
    ``remap_pose_to_origin_resolution`` on 3 poses, noise-free keypoints
    and σ 0.5 px noise. Every solve of the port is within 1e-6 (rotation
    entries), 1e-4 mm and 1e-6 px (rmsd) of the float64 least-squares
    pose. JAX's outputs agree within those tolerances plus JAX's own
    distance from that pose: its cv2 branch (``cv2.solvePnP``, whose LM
    stops up to ~2e-6 short of it) and its branch without cv2 (cv2 blocked
    on both sides), whose LM does not converge (ROADMAP Queue 3)."""
    import scflow_tpu.data.pipeline as jax_pipe
    import scflow_torch.data.pipeline as pipe

    tol = np.array([PNP_TOL["rotation"], PNP_TOL["translation"],
                    PNP_TOL["rmsd"]])
    if jax_branch == "no_cv2":
        monkeypatch.setitem(sys.modules, "cv2", None)
    for seed in range(3):
        rot, t, pts, k, crop, target_k = _pnp_case(seed)
        ours = _Solves(pipe._solve_pnp_np, sigma, seed)
        theirs = _Solves(jax_pipe._solve_pnp_np, sigma, seed)
        with mock.patch.object(pipe, "_solve_pnp_np", ours), \
                mock.patch.object(jax_pipe, "_solve_pnp_np", theirs):
            got = pipe.apply_geometry_transform_mode(
                crop, rot, t, pts, k, mode, target_k=target_k)
            want = jax_pipe.apply_geometry_transform_mode(
                crop, rot, t, pts, k, mode, target_k=target_k)
            back = pipe.remap_pose_to_origin_resolution(
                got[0], got[1], pts, got[2], crop.transform, k, mode)
            jback = jax_pipe.remap_pose_to_origin_resolution(
                got[0], got[1], pts, got[2], crop.transform, k, mode)
        np.testing.assert_array_equal(got[2], want[2])
        assert len(ours.calls) == len(theirs.calls) == (
            0 if mode == "adapt_intrinsic" else 2)
        spread = np.zeros(3)        # JAX's distance from the witness
        for (pts_, pix, clean, k_, r, t_), (_, _, jclean, _, jr, jt) in zip(
                ours.calls, theirs.calls):
            np.testing.assert_array_equal(clean, jclean)
            witness = _witness(pts_, pix, k_, r, t_)
            err = _errors((r, t_), witness, pts_, clean, k_)
            assert (err <= tol).all(), (seed, err)
            spread = np.maximum(spread, _errors((jr, jt), witness, pts_,
                                                clean, k_))
        gaps = np.array([max(np.abs(got[0] - want[0]).max(),
                             np.abs(back[0] - jback[0]).max()),
                         max(np.abs(got[1] - want[1]).max(),
                             np.abs(back[1] - jback[1]).max()),
                         abs(back[2] - jback[2])])
        assert (gaps <= tol + spread).all(), (seed, gaps, spread)
    assert "cv2" not in vars(pipe)


def test_geometry_mode_refusals():
    """An unknown mode and ``target_intrinsic`` without ``target_k``."""
    from scflow_torch.data.pipeline import (apply_geometry_transform_mode,
                                            remap_pose_to_origin_resolution)

    rot, t, pts, k, crop, _ = _pnp_case(0)
    for call in (lambda: apply_geometry_transform_mode(crop, rot, t, pts, k,
                                                       "other"),
                 lambda: apply_geometry_transform_mode(crop, rot, t, pts, k,
                                                       "target_intrinsic"),
                 lambda: remap_pose_to_origin_resolution(
                     rot, t, pts, k, crop.transform, k, "other")):
        with pytest.raises(ValueError):
            call()
    with mock.patch.dict(sys.modules, cv2=None):
        from scflow_torch.data.pipeline import remap_pose

        r, t2, rmsd = remap_pose(rot, t, pts, k, np.eye(3), k)
        np.testing.assert_allclose(r, rot, atol=1e-6)
        np.testing.assert_allclose(t2, t, atol=1e-3)
        assert rmsd < 1e-3
