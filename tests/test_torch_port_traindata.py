"""The port's training-data path against the JAX package's, on the CPU:
the train crop, the color augmentations, the train datasets, the train
batch builders (single-object and scene), the recipes, both CLIs' config
resolution, and the training CLI end to end on a BOP tree on disk.

The JAX side reads images through its C++ library and resizes, warps and
converts colors with cv2 (both here); the port with its PNG decoder and
``data.cvops``. The trees are written once per module by the port's
``make_synthetic_bop`` on the CPU (21 classes, as the YCB-V recipes
need): a ``train_real`` split, a ``test`` split, the same frames as a
track layout, and PNG backgrounds.
"""
import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import cv2
import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
FRAME = (128, 160)
CROP = 64
TRAIN_IMAGES, TEST_IMAGES = 6, 3


def _write_png(path, img):
    from scflow_torch.utils.tb_writer import encode_png

    Path(path).write_bytes(encode_png(img))


def _track_layout(train: Path, root: Path) -> None:
    """The train split as the track layout: track_01/{rgb,mask_visib} with
    5-digit file ids, the split's jsons, image_set/train.txt, and the
    tool's initial poses as the ref-annots root."""
    seq = train / "train_real" / "000001"
    track = root / "track_01"
    (track / "rgb").mkdir(parents=True)
    (track / "mask_visib").mkdir()
    for name in ("scene_gt.json", "scene_camera.json", "scene_gt_info.json"):
        os.symlink(seq / name, track / name)
    lines = []
    for img in sorted((seq / "rgb").iterdir()):
        i = int(img.stem)
        os.symlink(img, track / "rgb" / f"{i:05d}.png")
        lines.append(f"track_01/{i:05d}")
    for m in sorted((seq / "mask_visib").iterdir()):
        i, j = m.stem.split("_")
        os.symlink(m, track / "mask_visib" / f"{int(i):05d}_{j}.png")
    (root / "image_set").mkdir()
    (root / "image_set" / "train.txt").write_text("\n".join(lines) + "\n")
    (root / "init" / "track_01").mkdir(parents=True)
    os.symlink(train / "init_poses" / "000001" / "scene_gt.json",
               root / "init" / "track_01" / "scene_gt.json")


def _ycbv_layout(train: Path, test: Path, root: Path) -> None:
    """The paths the YCB-V recipes read, relative to ``root``."""
    ycbv = root / "data" / "ycbv"
    (ycbv / "image_lists").mkdir(parents=True)
    os.symlink(train / "train_real", ycbv / "train_real")
    os.symlink(test / "test", ycbv / "test")
    os.symlink(train / "models", ycbv / "models_1024")
    for tree, split in ((train, "train_real"), (test, "test")):
        os.symlink(tree / "image_lists" / f"{split}.txt",
                   ycbv / "image_lists" / f"{split}.txt")
    (root / "data" / "initial_poses").mkdir()
    os.symlink(test / "init_poses", root / "data" / "initial_poses"
               / "ycbv_posecnn")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    from scflow_torch.tools.make_synthetic_bop import main

    root = tmp_path_factory.mktemp("traindata")
    common = ["--num-classes", "21", "--height", str(FRAME[0]), "--width",
              str(FRAME[1]), "--min-objects", "2", "--max-objects", "4",
              "--device", "cpu"]
    main(["--out", str(root / "train"), "--split", "train_real",
          "--num-images", str(TRAIN_IMAGES), "--seed", "0", *common])
    test = main(["--out", str(root / "test"), "--split", "test",
                 "--num-images", str(TEST_IMAGES), "--seed", "1", *common])
    rng = np.random.default_rng(7)
    (root / "bg").mkdir()
    for i in range(3):
        _write_png(root / "bg" / f"{i:03d}.png",
                   rng.integers(0, 256, (96, 128, 3), np.uint8))
    _track_layout(root / "train", root / "track")
    _ycbv_layout(root / "train", root / "test", root / "layout")
    with open(root / "test" / "test" / "000001" / "scene_gt.json") as f:
        gt = json.load(f)
    return SimpleNamespace(root=root, train=root / "train", bg=root / "bg",
                           track=root / "track", layout=root / "layout",
                           test_objects=[len(gt[str(i)])
                                         for i in range(TEST_IMAGES)],
                           test_counts=test)


@pytest.fixture(scope="module")
def meshes(trees):
    """(points per class, diameters) of the tree's 21 meshes."""
    from scflow_torch.rendering import load_mesh_dir
    from scflow_torch.training import build_points_bank

    bank = load_mesh_dir(str(trees.train / "models"), device="cpu")
    points = build_points_bank(bank, num_points=512)
    return list(points.points.numpy()), list(points.diameters.numpy())


def _equal(got, want, what=""):
    """Exactly equal: the same keys, and arrays of the same dtype and
    values (NaN equal to NaN)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _equal(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for i, (a, b) in enumerate(zip(got, want)):
            _equal(a, b, f"{what}[{i}]")
    elif isinstance(want, (str, int, float)) and not isinstance(want, np.generic):
        assert got == want, what
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype, f"{what}: {got.dtype} vs {want.dtype}"
        np.testing.assert_array_equal(got, want, err_msg=what)


# -- the train crop --------------------------------------------------------

BOXES = [(30.2, 20.7, 90.9, 70.1), (-25.0, -10.5, 40.2, 30.3),
         (100.4, 80.2, 190.6, 150.8), (10.0, 40.0, 31.0, 50.0),
         (60.0, 5.0, 70.0, 120.0), (0.0, 0.0, 160.0, 128.0)]


@pytest.mark.parametrize("box", BOXES)
@pytest.mark.parametrize("size_ratio", [1.0, 1.17])
def test_crop_resize_pad_matches_jax(box, size_ratio):
    """Boxes inside, across and outside the frame, thin ones (odd ``rh``:
    the float pad offset), a mask: patch and mask bit-equal, transform and
    ``k_new`` exact."""
    from scflow_tpu.data.pipeline import crop_resize_pad as jax_crop
    from scflow_torch.data.pipeline import crop_resize_pad

    rng = np.random.default_rng(int(sum(box)))
    img = rng.integers(0, 256, (*FRAME, 3), np.uint8)
    mask = rng.random(FRAME) < 0.4
    k = np.array([[572.4, 0, 80.0], [0, 573.6, 64.0], [0, 0, 1]], np.float32)
    bbox = np.asarray(box, np.float32)
    args = (img, bbox, k, CROP)
    got = crop_resize_pad(*args, size_ratio=size_ratio, mask=mask)
    want = jax_crop(*args, size_ratio=size_ratio, mask=mask)
    _equal(dataclasses.asdict(got), dataclasses.asdict(want))


# -- color augmentations ----------------------------------------------------

def _aug_inputs(seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (CROP, CROP, 3), np.uint8)
    yy, xx = np.mgrid[:CROP, :CROP]
    mask = (yy - 30) ** 2 + (xx - 34) ** 2 < 18 ** 2
    occ = rng.integers(0, 256, (CROP, CROP, 3), np.uint8)
    occ_mask = (np.abs(yy - 20) < 12) & (np.abs(xx - 40) < 9)
    bg = rng.integers(0, 256, (96, 128, 3), np.uint8)
    return img, mask, occ, occ_mask, bg


AUGS = {
    "random_hsv": lambda m, r, i, mk, o, om, bg: m.random_hsv(r, i),
    "random_noise": lambda m, r, i, mk, o, om, bg: m.random_noise(r, i),
    "random_smooth": lambda m, r, i, mk, o, om, bg: m.random_smooth(r, i),
    "random_sharpness": lambda m, r, i, mk, o, om, bg: m.random_sharpness(r, i),
    "random_gray": lambda m, r, i, mk, o, om, bg: m.random_gray(r, i, p=0.5),
    "random_background": lambda m, r, i, mk, o, om, bg: m.random_background(
        r, i, mk, [bg, bg[::-1]], p=0.6),
    "random_occlusion": lambda m, r, i, mk, o, om, bg: m.random_occlusion(
        r, i, mk, p=0.7),
    "random_occlusion_v2": lambda m, r, i, mk, o, om, bg:
        m.random_occlusion_v2(r, i, mk, o, om, p=0.8),
    "default_train_augs": lambda m, r, i, mk, o, om, bg:
        m.default_train_augs(r, i),
}


@pytest.mark.parametrize("name", sorted(AUGS))
def test_color_aug_matches_jax(name):
    """Each function on the same input from the same seed, 12 times in a
    row (each branch taken): outputs bit-equal, and the Generator left in
    the JAX function's state after every call (the same draws)."""
    from scflow_tpu.data import color_aug as jax_aug
    from scflow_torch.data import color_aug

    inputs = _aug_inputs(len(name))
    rng, jrng = np.random.default_rng(11), np.random.default_rng(11)
    for call in range(12):
        got = AUGS[name](color_aug, rng, *inputs)
        want = AUGS[name](jax_aug, jrng, *inputs)
        _equal(got, want, f"{name} call {call}")
        assert rng.bit_generator.state == jrng.bit_generator.state


# -- datasets ---------------------------------------------------------------

def _supervise(trees, sample_num, jax=False):
    from scflow_torch.training import YCBV_CLASS_NAMES

    if jax:
        from scflow_tpu.data.bop import SuperviseTrainDataset
    else:
        from scflow_torch.data.bop import SuperviseTrainDataset
    return SuperviseTrainDataset(
        str(trees.train / "train_real"),
        str(trees.train / "image_lists" / "train_real.txt"),
        class_names=YCBV_CLASS_NAMES, sample_num=sample_num,
        min_visib_fract=0.2, seed=5)


def _track(trees, ref: bool, jax=False):
    if jax:
        from scflow_tpu.data.tracking import TrackDataset

        class TrackDataset(TrackDataset):       # the port's get
            def get(self, index, rng=None):
                return self[index]
    else:
        from scflow_torch.data.tracking import TrackDataset
    return TrackDataset(str(trees.track), str(trees.track / "image_set" /
                                              "train.txt"),
                        class_names=("object",) * 21,
                        ref_annots_root=str(trees.track / "init") if ref
                        else None, min_visib_fract=0.1)


def _concat(parts, jax=False):
    if jax:
        from scflow_tpu.data.bop import ConcatDataset

        class ConcatDataset(ConcatDataset):     # the port's get
            def get(self, index, rng=None):
                i = int(np.searchsorted(self._offsets, index,
                                        side="right")) - 1
                return self.datasets[i].get(index - int(self._offsets[i]),
                                            rng)
    else:
        from scflow_torch.data.bop import ConcatDataset
    return ConcatDataset(parts)


@pytest.mark.parametrize("sample_num", [1, 2, -1])
def test_supervise_dataset_matches_jax(trees, sample_num):
    """Every image through ``get`` with a caller's Generator and through
    ``__getitem__`` (the dataset's own): equal items and draws."""
    port, jax = _supervise(trees, sample_num), _supervise(trees, sample_num,
                                                          jax=True)
    assert len(port) == len(jax) == TRAIN_IMAGES
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    for i in range(TRAIN_IMAGES):
        _equal(port.get(i, rng), jax.get(i, jrng), f"get {i}")
        _equal(port[i], jax[i], f"item {i}")
    assert rng.bit_generator.state == jrng.bit_generator.state
    assert port.rng.bit_generator.state == jax.rng.bit_generator.state


@pytest.mark.parametrize("ref", [False, True])
def test_track_dataset_matches_jax(trees, ref):
    """The track layout with and without initial poses: equal items;
    ``get`` equals ``__getitem__`` and draws nothing."""
    port, jax = _track(trees, ref), _track(trees, ref, jax=True)
    assert len(port) == len(jax) == TRAIN_IMAGES
    rng = np.random.default_rng(0)
    state = rng.bit_generator.state
    for i in range(TRAIN_IMAGES):
        _equal(port[i], jax[i], f"item {i}")
        _equal(port.get(i, rng), port[i], f"get {i}")
    assert rng.bit_generator.state == state


def test_concat_dataset_matches_jax(trees):
    """A concatenation of the BOP split and its track layout: items by
    index equal to JAX's, and ``get`` passes the caller's Generator to
    the part (to JAX's parts through the test's ``get``)."""
    port = _concat([_supervise(trees, 1), _track(trees, False)])
    jax = _concat([_supervise(trees, 1, jax=True),
                   _track(trees, False, jax=True)], jax=True)
    assert len(port) == len(jax) == 2 * TRAIN_IMAGES
    rng, jrng = np.random.default_rng(4), np.random.default_rng(4)
    for i in range(len(port)):
        _equal(port[i], jax[i], f"item {i}")
        _equal(port.get(i, rng), jax.get(i, jrng), f"get {i}")
    assert rng.bit_generator.state == jrng.bit_generator.state


# -- batch builders ---------------------------------------------------------

def _configs(**data):
    from scflow_tpu.training.config import Config as JaxConfig
    from scflow_tpu.training.config import DataConfig as JaxDataConfig
    from scflow_torch.training.config import Config, DataConfig

    data = dict(batch_size=4, image_scale=CROP, **data)
    return Config(data=DataConfig(**data)), JaxConfig(data=JaxDataConfig(**data))


def _aug_data(trees, aug: str) -> dict:
    if aug == "off":
        return dict(color_aug=False)
    return dict(color_aug=True, background_dir=str(trees.bg),
                background_p=0.5, occlusion_p=0.5, occlusion_v2_p=0.5)


@pytest.mark.parametrize("aug", ["off", "on"])
@pytest.mark.parametrize("seed", [0, 1])
def test_train_batch_builder_matches_jax(trees, meshes, seed, aug):
    """3 batches of 4 objects, with every augmentation off, then on
    (color, PNG backgrounds, noise and object-paste occlusion): every
    array bit-equal to JAX's — crops and masks, poses, K, labels, init
    errors — and the same draws."""
    from scflow_tpu.data.loader import TrainBatchBuilder as JaxBuilder
    from scflow_torch.data.loader import TrainBatchBuilder

    cfg, jcfg = _configs(**_aug_data(trees, aug))
    b = TrainBatchBuilder(_supervise(trees, 1), cfg, *meshes, seed=seed)
    jb = JaxBuilder(_supervise(trees, 1, jax=True), jcfg, *meshes, seed=seed)
    for i in range(3):
        batch = b()
        _equal(batch, jb(), f"batch {i}")
        assert batch["real_images"].shape == (4, CROP, CROP, 3)
    assert b.rng.bit_generator.state == jb.rng.bit_generator.state
    assert len(b._occluder_pool) == len(jb._occluder_pool)
    assert (len(b._occluder_pool) > 0) == (aug == "on")


@pytest.mark.parametrize("aug", ["off", "on"])
@pytest.mark.parametrize("seed", [0, 1])
def test_scene_batch_builder_matches_jax(trees, meshes, seed, aug):
    """2 scene batches of 2 images × 3 slots (images with more objects
    than slots and with fewer, so filler slots): bit-equal to JAX's,
    ``sample_valid`` included."""
    from scflow_tpu.data.loader import SceneTrainBatchBuilder as JaxBuilder
    from scflow_torch.data.loader import SceneTrainBatchBuilder

    cfg, jcfg = _configs(**_aug_data(trees, aug))
    kw = dict(seed=seed, num_images=2, slots_per_image=3)
    b = SceneTrainBatchBuilder(_supervise(trees, -1), cfg, *meshes, **kw)
    jb = JaxBuilder(_supervise(trees, -1, jax=True), jcfg, *meshes, **kw)
    valid = []
    for i in range(2):
        batch = b()
        _equal(batch, jb(), f"batch {i}")
        valid += batch["sample_valid"].tolist()
    assert b.rng.bit_generator.state == jb.rng.bit_generator.state
    assert len(valid) == 12


def test_builder_on_concat_and_track_matches_jax(trees, meshes):
    """The builder over a concatenation of the BOP split and the track
    layout, each reached through ``get`` (JAX's classes given the port's
    ``get`` in the test), and ``spawn``'s worker streams: bit-equal."""
    from scflow_tpu.data.loader import TrainBatchBuilder as JaxBuilder
    from scflow_torch.data.loader import TrainBatchBuilder

    cfg, jcfg = _configs(color_aug=True)
    b = TrainBatchBuilder(_concat([_supervise(trees, 1),
                                   _track(trees, True)]), cfg, *meshes, seed=2)
    jb = JaxBuilder(_concat([_supervise(trees, 1, jax=True),
                             _track(trees, True, jax=True)], jax=True),
                    jcfg, *meshes, seed=2)
    for worker in range(2):
        w, jw = b.spawn(worker), jb.spawn(worker)
        _equal(w(), jw(), f"worker {worker}")
        assert w.rng.bit_generator.state == jw.rng.bit_generator.state
    _equal(b(), jb(), "parent")


def test_jpeg_background_is_refused(trees, meshes, tmp_path):
    """A background the port cannot decode (a CMYK JPEG) raises
    ``ValueError`` naming the file when the builder is built; the JAX
    package would skip it each time it is drawn."""
    from PIL import Image

    from scflow_torch.data.loader import TrainBatchBuilder

    ok, bad = tmp_path / "a.png", tmp_path / "b.jpg"
    img = np.random.default_rng(0).integers(0, 256, (32, 48, 3), np.uint8)
    _write_png(ok, img)
    Image.fromarray(img).convert("CMYK").save(bad, quality=90)
    cfg, _ = _configs(background_dir=str(tmp_path))
    with pytest.raises(ValueError, match="b.jpg.*CMYK"):
        TrainBatchBuilder(_supervise(trees, 1), cfg, *meshes)
    bad.unlink()
    TrainBatchBuilder(_supervise(trees, 1), cfg, *meshes)


def test_jpeg_background_is_read(trees, meshes, tmp_path):
    """A baseline JPEG in ``background_dir`` is accepted when the builder
    is built and drawn as cv2 decodes it."""
    from scflow_torch.data.loader import TrainBatchBuilder

    img = np.random.default_rng(1).integers(0, 256, (32, 48, 3), np.uint8)
    cv2.imwrite(str(tmp_path / "b.jpg"), img[..., ::-1],
                [cv2.IMWRITE_JPEG_QUALITY, 90])
    cfg, _ = _configs(background_dir=str(tmp_path))
    b = TrainBatchBuilder(_supervise(trees, 1), cfg, *meshes)
    np.testing.assert_array_equal(
        b._load_background(),
        cv2.imread(str(tmp_path / "b.jpg"), cv2.IMREAD_COLOR)[..., ::-1])


def test_prefetch_raises_a_worker_error_and_stops():
    """A worker's exception is raised by the consumer (the JAX prefetch
    would wait forever); closing the generator stops the workers."""
    import threading

    from scflow_torch.data.loader import prefetch

    calls = []

    class Source:
        def __init__(self, fail):
            self.fail = fail

        def spawn(self, i):
            return Source(self.fail)

        def __call__(self):
            calls.append(1)
            if self.fail:
                raise OSError("disk gone")
            return {"x": np.zeros(2)}

    with pytest.raises(OSError, match="disk gone"):
        next(prefetch(Source(fail=True)))
    before = threading.active_count()
    it = prefetch(Source(fail=False), num_workers=3)
    assert next(it)["x"].shape == (2,)
    it.close()
    assert threading.active_count() <= before
    assert len(calls) > 1


# -- recipes and config resolution ------------------------------------------

def _equal_config(port, jax, what="config"):
    """Every field of the port's dataclass equals JAX's field of that name
    (JAX's config has fields for paths the port does not run)."""
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(jax, f.name)
        if dataclasses.is_dataclass(a):
            _equal_config(a, b, f"{what}.{f.name}")
        else:
            assert a == b, f"{what}.{f.name}: {a!r} vs {b!r}"


def test_recipe_registry_matches_jax():
    import scflow_tpu.configs as jax_configs
    from scflow_torch import configs

    assert sorted(configs.RECIPES) == sorted(jax_configs.RECIPES)
    assert "scflow_ycbv_pbr_scene" not in configs.RECIPES
    with pytest.raises(KeyError, match="unknown recipe"):
        configs.get_recipe("scflow_ycbv_pbr_scene")


@pytest.mark.parametrize("name", sorted([
    "scflow_ycbv_pbr", "scflow_ycbv_pbr_scene", "scflow_ycbv_real",
    "scflow_ycbv_mixpbr", "scflow_ycbv_mix20real", "raft_ycbv",
    "scflow_track_real", "scflow_track_syn", "scflow_track_real_mix_syn"]))
def test_recipe_matches_jax(name):
    """Each recipe's Config fieldwise and its train and test
    DatasetSpecs equal to JAX's."""
    import scflow_tpu.configs as jax_configs
    from scflow_torch import configs

    port, jax = getattr(configs, name)(), getattr(jax_configs, name)()
    _equal_config(port.config, jax.config)
    for split in ("train_data", "test_data"):
        assert (dataclasses.asdict(getattr(port, split))
                == dataclasses.asdict(getattr(jax, split))), split


def _jax_cli(name: str):
    """The JAX package's root CLI module ``name`` (train.py / test.py)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  REPO / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TRAIN_FLAGS = [
    [],
    ["--config", "scflow_ycbv_pbr"],
    ["--config", "raft_ycbv", "--iters", "3", "--lr", "1e-3"],
    ["--config", "scflow_ycbv_real", "--scene", "--scene-images", "2",
     "--slots-per-image", "3"],
    ["--scene", "--batch-size", "4"],
    ["--config", "scflow_ycbv_mixpbr", "--batch-size", "8", "--steps", "7"],
    ["--config", "scflow_track_real_mix_syn", "--steps", "5", "--cycles", "2",
     "--image-size", "128", "--work-dir", "w", "--seed", "3",
     "--num-classes", "2", "--data-root", "d", "--image-list", "l",
     "--mesh-dir", "m", "--mesh-ext", "obj", "--eval-every", "4"],
]


@pytest.mark.parametrize("flags", TRAIN_FLAGS, ids=lambda f: " ".join(f) or "none")
def test_train_resolve_config_matches_jax(flags, monkeypatch):
    """``resolve_config`` of both training CLIs on the same flag line:
    the config fieldwise, both DatasetSpecs; the port sets the render
    size to the crop size."""
    from scflow_torch import train

    jax_train = _jax_cli("train")
    monkeypatch.setattr(sys, "argv", ["train.py", *flags])
    jcfg, jtrain, jtest = jax_train.resolve_config(jax_train.parse_args())
    cfg, spec, test_spec = train.resolve_config(train.parse_args(flags))
    _equal_config(dataclasses.replace(cfg, render=jcfg.render), jcfg)
    assert cfg.render.image_size == (cfg.data.image_scale,) * 2
    for got, want in ((spec, jtrain), (test_spec, jtest)):
        assert (got is None and want is None) or (
            dataclasses.asdict(got) == dataclasses.asdict(want))


class _Stop(Exception):
    pass


TEST_FLAGS = [
    ["--config", "scflow_ycbv_pbr"],
    ["--config", "scflow_track_real", "--data-root", "x", "--mesh-dir", "m"],
    ["--config", "raft_ycbv", "--image-list", "l", "--mesh-ext", "obj"],
    ["--data-root", "a", "--ref-annots-root", "b", "--image-list", "c",
     "--mesh-dir", "d"],
]


@pytest.mark.parametrize("flags", TEST_FLAGS, ids=" ".join)
def test_test_cli_config_matches_jax(flags, monkeypatch):
    """The eval CLIs' ``--config``: the test paths, mesh dir and extension
    the recipe fills in are JAX's; a line without paths and recipe is
    refused by both."""
    import argparse

    import scflow_tpu.parallel
    from scflow_torch import test as port_test

    jax_test = _jax_cli("test")
    seen = {}
    parse = argparse.ArgumentParser.parse_args

    def capture(self, *a, **kw):
        seen["args"] = parse(self, *a, **kw)
        return seen["args"]

    def stop():
        raise _Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    monkeypatch.setattr(scflow_tpu.parallel, "initialize_distributed", stop)
    monkeypatch.setattr(sys, "argv", ["test.py", *flags])
    with pytest.raises(_Stop):
        jax_test.main()
    want = vars(seen["args"])
    got = vars(port_test.resolve_args(port_test.parse_args(flags)))
    for key in ("config", "data_root", "ref_annots_root", "image_list",
                "mesh_dir", "mesh_ext"):
        assert got[key] == want[key], key
    monkeypatch.setattr(sys, "argv", ["test.py", "--data-root", "x"])
    with pytest.raises(SystemExit):
        jax_test.main()
    with pytest.raises(SystemExit):
        port_test.resolve_args(port_test.parse_args(["--data-root", "x"]))


# -- the CLI end to end -----------------------------------------------------

def _read_log(work):
    with open(os.path.join(work, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _small(work) -> list:
    return ["--device", "cpu", "--image-size", str(CROP), "--iters", "2",
            "--work-dir", str(work)]


@pytest.mark.parametrize("scene", [False, True])
def test_cli_trains_from_disk(trees, tmp_path, scene):
    """``python -m scflow_torch.train --data-root …`` on the CPU: 2 steps
    at 64², 21 classes, batch 2 (``--scene``: 1 image × 2 slots), losses
    finite, the final checkpoint written."""
    from scflow_torch.train import main
    from scflow_torch.training.checkpoint import list_checkpoint_steps

    work = tmp_path / "run"
    flags = (["--scene", "--scene-images", "1", "--slots-per-image", "2"]
             if scene else ["--batch-size", "2"])
    trainer = main(_small(work) + [
        "--data-root", str(trees.train / "train_real"),
        "--image-list", str(trees.train / "image_lists" / "train_real.txt"),
        "--mesh-dir", str(trees.train / "models"), "--num-classes", "21",
        "--steps", "2", *flags])
    assert trainer.step == 2 and trainer.cfg.data.batch_size == 2
    assert trainer.cfg.data.scene_mode == scene
    log = _read_log(work)
    assert np.isfinite([log[0][k] for k in ("loss", "loss_pose", "loss_flow",
                                            "loss_mask", "grad_norm")]).all()
    assert list_checkpoint_steps(str(work / "checkpoints")) == [2]


def test_cli_trains_from_a_recipe(trees, tmp_path, monkeypatch):
    """``--config scflow_ycbv_real`` in a directory laid out as the recipe
    reads it (its train split, meshes and test split), every augmentation
    on, with the on-disk eval every 2 steps over the first 2 test images;
    then the eval CLI's ``--config`` on the same test split."""
    from scflow_torch import configs
    from scflow_torch import test as test_cli
    from scflow_torch.train import main

    monkeypatch.chdir(trees.layout)
    work = tmp_path / "run"
    real = configs.scflow_ycbv_real()
    real.config.data = dataclasses.replace(
        real.config.data, background_dir=str(trees.bg), occlusion_p=0.5,
        occlusion_v2_p=0.5)
    with mock.patch.dict(configs.RECIPES, scflow_ycbv_real=lambda: real):
        trainer = main(_small(work) + [
            "--config", "scflow_ycbv_real", "--batch-size", "2",
            "--steps", "2", "--eval-every", "2", "--eval-limit", "2"])
    assert trainer.step == 2
    log = _read_log(work)
    evals = [r for r in log if "eval/num_instances" in r]
    assert len(evals) == 1
    assert evals[0]["eval/num_instances"] == sum(trees.test_objects[:2])
    assert 0.0 <= evals[0]["eval/average/add_0.10d"] <= 1.0
    metrics, _ = test_cli.main(["--config", "scflow_ycbv_real", "--device",
                                "cpu", "--image-size", str(CROP), "--iters",
                                "2", "--limit", "2", "--slot-budget", "8",
                                "--work-dir", str(tmp_path / "eval")])
    assert metrics["num_instances"] == sum(trees.test_objects[:2])


BLOCKED_RUN = """
import sys
for name in ("cv2", "PIL", "jax", "scflow_tpu"):
    sys.modules[name] = None        # any import of it now raises
import dataclasses
from scflow_torch import configs
from scflow_torch.train import main
real = configs.scflow_ycbv_real()
real.config.data = dataclasses.replace(
    real.config.data, background_dir=sys.argv[1], occlusion_p=1.0,
    occlusion_v2_p=1.0, background_p=1.0)
configs.RECIPES["scflow_ycbv_real"] = lambda: real
trainer = main(["--config", "scflow_ycbv_real", "--device", "cpu",
                "--image-size", "64", "--iters", "2", "--batch-size", "2",
                "--steps", "1", "--work-dir", sys.argv[2]])
assert trainer.step == 1
print(sorted(m for m in ("cv2", "PIL", "jax", "scflow_tpu")
             if sys.modules.get(m) is not None))
"""


def test_cli_trains_without_cv2_pil_or_jax(trees, tmp_path):
    """The recipe run with every augmentation drawn on each sample, in a
    process where cv2, PIL, JAX and scflow_tpu cannot be imported (the
    GPU machine has none of them)."""
    import subprocess

    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", BLOCKED_RUN, str(trees.bg),
                        str(tmp_path / "run")], cwd=str(trees.layout),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"
