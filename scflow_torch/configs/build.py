"""Build dataset objects from a :class:`~scflow_torch.configs.DatasetSpec`
(port of ``scflow_tpu/configs/build.py``).

The registry-free ``DATASETS.build(cfg)`` analogue: recipe specs are plain
data; this module turns them into reader instances.
"""
from __future__ import annotations

from ..data.bop import ConcatDataset, RefineDataset, SuperviseTrainDataset
from ..data.tracking import TrackDataset
from . import DatasetSpec


def build_dataset(spec: DatasetSpec, *, seed: int = 0, sample_num: int = 1):
    """Instantiate the dataset(s) a spec describes (concat if several
    roots). ``sample_num=-1`` keeps every visible object per image (scene
    batching)."""
    parts = []
    for root, image_list in zip(spec.data_roots, spec.image_lists):
        if spec.kind == "supervise":
            parts.append(SuperviseTrainDataset(
                root, image_list, class_names=spec.class_names,
                sample_num=sample_num,
                min_visib_fract=spec.min_visib_fract, seed=seed))
        elif spec.kind == "refine":
            parts.append(RefineDataset(
                root, spec.ref_annots_root, image_list,
                class_names=spec.class_names))
        elif spec.kind == "track":
            parts.append(TrackDataset(
                root, image_list, class_names=spec.class_names,
                ref_annots_root=spec.ref_annots_root,
                min_visib_fract=spec.min_visib_fract,
                digits=spec.digits, image_ext=spec.image_ext))
        else:
            raise ValueError(f"unknown dataset kind {spec.kind!r}")
    if len(parts) == 1:
        return parts[0]
    return ConcatDataset(parts)
