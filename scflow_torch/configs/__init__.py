"""Named training/eval recipes — the reference config-file equivalents
(port of ``scflow_tpu/configs/__init__.py``: the same names, fields and
paths).

The reference ships executable-python mmengine configs
(configs/refine_models/*.py, configs/refine_datasets/*.py); here each
recipe is a function returning a fully-populated :class:`RecipeSpec`
(typed :class:`~scflow_torch.training.config.Config` + dataset wiring), and
``get_recipe(name)`` is the ``Config.fromfile`` analogue used by
``python -m scflow_torch.train --config <name>`` and
``python -m scflow_torch.test --config <name>``.

Recipe inventory (reference counterpart in parens):
- ``scflow_ycbv_pbr``        (configs/refine_models/scflow_ycbv_pbr.py)
- ``scflow_ycbv_real``       (configs/refine_models/scflow_ycbv_real.py)
- ``scflow_ycbv_mixpbr``     (configs/refine_datasets/ycbv_mixpbr.py data variant)
- ``scflow_ycbv_mix20real``  (configs/refine_datasets/ycbv_mix20real.py)
- ``raft_ycbv``              (configs/refine_models/raft.py — flow+occlusion family)
- ``scflow_track_real`` / ``scflow_track_syn`` / ``scflow_track_real_mix_syn``
  (the fork's configs/refine_models/scflow_lumi_piano_*.py, generalized to
  any single-class tracking-layout dataset)

``scflow_ycbv_pbr_scene`` is defined but, as in the JAX package, not in
``RECIPES``: ``get_recipe`` does not know it.
"""
from __future__ import annotations

import dataclasses

from ..training.config import (YCBV_CLASS_NAMES, YCBV_MESH_DIAMETERS,
                               YCBV_SYMMETRIC_CLASSES, Config, DataConfig,
                               LossConfig, ModelConfig)


@dataclasses.dataclass
class DatasetSpec:
    """Where/how to read one training or eval dataset.

    ``kind``: 'supervise' (GT + jitter), 'refine' (paired external initial
    poses), or 'track' (tracking directory layout). ``data_roots`` may hold
    several roots — they are concatenated, the reference ConcatDataset
    analogue (configs/refine_models/scflow_lumi_piano_real_mix_syn.py:98-129).
    """
    kind: str = "supervise"
    data_roots: tuple = ()
    image_lists: tuple = ()
    ref_annots_root: str | None = None
    mesh_dir: str | None = None
    mesh_ext: str = "ply"
    class_names: tuple = YCBV_CLASS_NAMES
    symmetric_classes: tuple = ()
    diameters: tuple | None = None
    min_visib_fract: float = 0.0
    digits: int = 6                  # file-id zero padding (track layout: 5)
    image_ext: str = "png"


@dataclasses.dataclass
class RecipeSpec:
    config: Config
    train_data: DatasetSpec | None = None
    test_data: DatasetSpec | None = None


def _ycbv_spec(split: str, *, min_visib_fract: float = 0.0,
               extra_roots: tuple = ()) -> DatasetSpec:
    root = f"data/ycbv/{split}"
    return DatasetSpec(
        kind="supervise",
        data_roots=(root,) + tuple(extra_roots),
        image_lists=tuple(f"data/ycbv/image_lists/{r.rsplit('/', 1)[-1]}.txt"
                          for r in (root,) + tuple(extra_roots)),
        mesh_dir="data/ycbv/models_1024",
        class_names=YCBV_CLASS_NAMES,
        symmetric_classes=YCBV_SYMMETRIC_CLASSES,
        diameters=YCBV_MESH_DIAMETERS,
        min_visib_fract=min_visib_fract,
    )


def _ycbv_test_spec() -> DatasetSpec:
    return DatasetSpec(
        kind="refine",
        data_roots=("data/ycbv/test",),
        image_lists=("data/ycbv/image_lists/test.txt",),
        ref_annots_root="data/initial_poses/ycbv_posecnn",
        mesh_dir="data/ycbv/models_1024",
        class_names=YCBV_CLASS_NAMES,
        symmetric_classes=YCBV_SYMMETRIC_CLASSES,
        diameters=YCBV_MESH_DIAMETERS,
    )


def scflow_ycbv_pbr() -> RecipeSpec:
    """Flagship: SCFlow on YCB-V PBR-rendered training images
    (configs/refine_models/scflow_ycbv_pbr.py — 8 GRU iters, 4-level
    pyramid r=4, ortho6d, disentangled point-matching w=10 + RAFT flow
    w=0.1 + mask L1 w=10, gamma 0.8, AdamW 4e-4 OneCycle 100k, batch 16,
    min_visib_fract 0.2)."""
    return RecipeSpec(
        config=Config(work_dir="work_dirs/scflow_ycbv_pbr"),
        train_data=_ycbv_spec("train_pbr", min_visib_fract=0.2),
        test_data=_ycbv_test_spec(),
    )


def scflow_ycbv_pbr_scene() -> RecipeSpec:
    """Multi-object scene training (BASELINE.md config 4): every visible
    object of each sampled image shares one batch; padded slots are masked
    by ``sample_valid`` in the loss and the context encoder's BN statistics.
    No reference counterpart — the reference handles this with ragged
    per-image object lists (models/refiner/base_refiner.py:95,160-167)."""
    cfg = Config(
        data=DataConfig(scene_mode=True, scene_images=4, slots_per_image=4,
                        min_visib_fract=0.2),
        work_dir="work_dirs/scflow_ycbv_pbr_scene",
    )
    return RecipeSpec(
        config=cfg,
        train_data=_ycbv_spec("train_pbr", min_visib_fract=0.2),
        test_data=_ycbv_test_spec(),
    )


def scflow_ycbv_real() -> RecipeSpec:
    """SCFlow trained on real YCB-V images, no visibility filter
    (configs/refine_models/scflow_ycbv_real.py)."""
    return RecipeSpec(
        config=Config(work_dir="work_dirs/scflow_ycbv_real"),
        train_data=_ycbv_spec("train_real"),
        test_data=_ycbv_test_spec(),
    )


def scflow_ycbv_mixpbr() -> RecipeSpec:
    """Real + PBR mixed training (configs/refine_datasets/ycbv_mixpbr.py —
    incl. RandomBackground(background_dir='data/coco', p=0.3), :49) +
    object-paste occlusion (RandomOcclusionV2 behavior class,
    color_transform.py:329-403; no shipped reference config enables it —
    opt-in here for real-data robustness)."""
    return RecipeSpec(
        config=Config(work_dir="work_dirs/scflow_ycbv_mixpbr",
                      data=DataConfig(background_dir="data/coco",
                                      background_p=0.3,
                                      occlusion_v2_p=0.3,
                                      min_visib_fract=0.2)),
        train_data=_ycbv_spec("train_real", min_visib_fract=0.2,
                              extra_roots=("data/ycbv/train_pbr",)),
        test_data=_ycbv_test_spec(),
    )


def scflow_ycbv_mix20real() -> RecipeSpec:
    """PBR + every-20th real image (configs/refine_datasets/ycbv_mix20real.py
    — incl. RandomBackground(background_dir='data/coco', p=0.3), :49)."""
    spec = _ycbv_spec("train_pbr", min_visib_fract=0.2,
                      extra_roots=("data/ycbv/train_real",))
    spec = dataclasses.replace(
        spec, image_lists=(spec.image_lists[0],
                           "data/ycbv/image_lists/train_real_every20.txt"))
    return RecipeSpec(
        config=Config(work_dir="work_dirs/scflow_ycbv_mix20real",
                      data=DataConfig(background_dir="data/coco",
                                      background_p=0.3,
                                      occlusion_v2_p=0.3,
                                      min_visib_fract=0.2)),
        train_data=spec,
        test_data=_ycbv_test_spec(),
    )


def raft_ycbv() -> RecipeSpec:
    """RAFT flow+occlusion refiner, pose via RANSAC-EPnP from flow
    (configs/refine_models/raft.py — family raft_flow_mask, 12 iters,
    flow + occlusion-mask losses, no pose head)."""
    cfg = Config(
        model=ModelConfig(family="raft_flow_mask", iters=12, test_iters=12),
        loss=LossConfig(pose_weight=0.0, flow_weight=1.0, mask_weight=1.0),
        work_dir="work_dirs/raft_ycbv",
    )
    return RecipeSpec(config=cfg,
                      train_data=_ycbv_spec("train_real"),
                      test_data=_ycbv_test_spec())


def _track_spec(root: str, image_list: str, *, ref_annots_root=None,
                kind="track") -> DatasetSpec:
    return DatasetSpec(
        kind=kind, data_roots=(root,), image_lists=(image_list,),
        ref_annots_root=ref_annots_root,
        mesh_dir="data/track/models", mesh_ext="obj",
        class_names=("object",), digits=5,
    )


def scflow_track_real() -> RecipeSpec:
    """Single-class tracking-layout recipe, real captures
    (configs/refine_models/scflow_lumi_piano_real.py analogue)."""
    cfg = Config(model=ModelConfig(num_class=1),
                 work_dir="work_dirs/scflow_track_real")
    return RecipeSpec(
        config=cfg,
        train_data=_track_spec("data/track/real",
                               "data/track/real/image_set/train.txt"),
        test_data=_track_spec("data/track/real",
                              "data/track/real/image_set/test.txt",
                              ref_annots_root="data/track/init_poses"),
    )


def scflow_track_syn() -> RecipeSpec:
    """Single-class tracking-layout recipe, synthetic renders
    (configs/refine_models/scflow_lumi_piano_syn.py analogue)."""
    cfg = Config(model=ModelConfig(num_class=1),
                 work_dir="work_dirs/scflow_track_syn")
    return RecipeSpec(
        config=cfg,
        train_data=_track_spec("data/track/syn",
                               "data/track/syn/image_set/train.txt"),
        test_data=_track_spec("data/track/real",
                              "data/track/real/image_set/test.txt",
                              ref_annots_root="data/track/init_poses"),
    )


def scflow_track_real_mix_syn() -> RecipeSpec:
    """Real + synthetic concatenated (ConcatDataset analogue,
    configs/refine_models/scflow_lumi_piano_real_mix_syn.py)."""
    cfg = Config(model=ModelConfig(num_class=1),
                 work_dir="work_dirs/scflow_track_real_mix_syn")
    train = DatasetSpec(
        kind="track",
        data_roots=("data/track/real", "data/track/syn"),
        image_lists=("data/track/real/image_set/train.txt",
                     "data/track/syn/image_set/train.txt"),
        mesh_dir="data/track/models", mesh_ext="obj",
        class_names=("object",), digits=5,
    )
    return RecipeSpec(
        config=cfg, train_data=train,
        test_data=_track_spec("data/track/real",
                              "data/track/real/image_set/test.txt",
                              ref_annots_root="data/track/init_poses"),
    )


RECIPES = {
    "scflow_ycbv_pbr": scflow_ycbv_pbr,
    "scflow_ycbv_real": scflow_ycbv_real,
    "scflow_ycbv_mixpbr": scflow_ycbv_mixpbr,
    "scflow_ycbv_mix20real": scflow_ycbv_mix20real,
    "raft_ycbv": raft_ycbv,
    "scflow_track_real": scflow_track_real,
    "scflow_track_syn": scflow_track_syn,
    "scflow_track_real_mix_syn": scflow_track_real_mix_syn,
}


def get_recipe(name: str) -> RecipeSpec:
    """Look up a named recipe (``Config.fromfile`` analogue)."""
    if name not in RECIPES:
        raise KeyError(f"unknown recipe {name!r}; available: "
                       f"{sorted(RECIPES)}")
    return RECIPES[name]()
