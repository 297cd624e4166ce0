"""Host-side eval batch assembly (port of ``scflow_tpu/data/loader.py:226-345``):
per-image crops of every object at its reference pose, and padding of an
image's objects to a fixed slot count.

Every batch is a dict of stacked numpy arrays in the JAX layout; the eval
loop (``training/evaluate.py``) packs several images into one batch.
"""
from __future__ import annotations

import numpy as np

from ..training.config import Config
from .bop import RefineDataset
from .pipeline import crop_resize_pad_batch, expand_bbox, project_bbox


class TestBatchBuilder:
    """Per-image eval batches from a RefineDataset: all objects of an image
    cropped at their reference-pose bboxes (reference test pipeline: crop
    ``cfg.data.test_crop_size``× the bbox, resize, pad, adapt K).

    One crop path: :func:`~.pipeline.crop_resize_pad_batch`, the JAX
    package's C++ crop semantics (its ``native_crop="on"``), giving
    normalised f32 crops and K' = T·K.
    """

    def __init__(self, dataset: RefineDataset, cfg: Config,
                 mesh_points_per_class: list[np.ndarray]):
        self.dataset = dataset
        self.cfg = cfg
        self.mesh_points = mesh_points_per_class

    def __len__(self):
        return len(self.dataset)

    def _crops(self, item: dict, n: int):
        boxes = np.empty((n, 4), np.float32)
        for i in range(n):
            label = int(item["labels"][i])
            bbox = project_bbox(self.mesh_points[label], item["k"][i],
                                item["ref_rotations"][i],
                                item["ref_translations"][i])
            boxes[i] = expand_bbox(bbox,
                                   size_ratio=self.cfg.data.test_crop_size)
        imgs, transforms = crop_resize_pad_batch(
            [item["image"]] * n, boxes, self.cfg.data.image_scale,
            mean=self.cfg.data.normalize_mean,
            std=self.cfg.data.normalize_std)
        ks = np.einsum("nij,njk->nik", transforms,
                       item["k"].astype(np.float32))
        return imgs, ks, transforms

    def __getitem__(self, index: int) -> dict | None:
        item = self.dataset[index]
        if item is None:
            return None
        imgs, ks, transforms = self._crops(item, len(item["labels"]))
        out = {
            "real_images": imgs,
            "ref_rotations": item["ref_rotations"],
            "ref_translations": item["ref_translations"],
            "k": ks,
            "labels": item["labels"].astype(np.int32),
            "transform_matrix": transforms,
            "scene_id": item["scene_id"],
            "img_id": item["img_id"],
            "ori_k": item["ori_k"],
        }
        for key in ("gt_rotations", "gt_translations", "gt_labels"):
            if key in item:
                out[key] = item[key]
        return out


def pad_to_batch(batch: dict, batch_size: int) -> dict:
    """Pad an n-object batch to a fixed size with a ``sample_valid`` mask
    (fixed-shape handling of variable object counts — SURVEY.md hard part 5)."""
    n = len(batch["labels"])
    if n > batch_size:
        raise ValueError(f"{n} objects exceed batch budget {batch_size}")
    out = {}
    valid = np.zeros((batch_size,), np.float32)
    valid[:n] = 1.0
    for k, v in batch.items():
        v = np.asarray(v)
        if v.ndim >= 1 and v.shape[0] == n and k not in (
                "scene_id", "img_id", "ori_k"):
            pad_shape = (batch_size - n,) + v.shape[1:]
            filler = (np.tile(v[:1], (batch_size - n,) + (1,) * (v.ndim - 1))
                      if n > 0 else np.zeros(pad_shape, v.dtype))
            out[k] = np.concatenate([v, filler], axis=0)
        else:
            out[k] = v
    out["sample_valid"] = valid
    return out
