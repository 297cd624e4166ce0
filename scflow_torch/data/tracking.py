"""Track-layout dataset variant (the fork's LUMI-piano family; port of
``scflow_tpu/data/tracking.py``).

The reference fork adds datasets for a single-object tracking layout
(datasets/lumi_piano_refine.py, lumi_piano_supervise_refine.py):
``track_XX/`` directories with ``rgb/``, ``mask_visib/``, BOP-style jsons
and ``image_set/*_test.txt`` image lists with 5-digit file ids. This module
generalizes that: a :class:`TrackDataset` reading any single-or-multi
object track directory tree, reusing the BOP annot format. Images are
read by the port's PNG and JPEG decoders (``data.imageio``).

One deliberate difference: :meth:`TrackDataset.get` (the train builders'
entry, equal to ``__getitem__``: the dataset draws nothing). The JAX
package's class has none, so its builders fail on a track dataset.

Layout:
  root/
    track_01/{rgb,mask_visib,scene_gt.json,scene_camera.json,scene_gt_info.json}
    track_02/...
    image_set/train.txt | test.txt   (lines: 'track_01/00001' or full paths)
"""
from __future__ import annotations

from os import path as osp

import numpy as np

from .bop import BaseBopDataset, BopSequenceAnnots
from .imageio import imread


class TrackDataset(BaseBopDataset):
    """Tracking-layout dataset for train (GT poses + jitter downstream) or
    eval (with a ref_annots_root of initial poses)."""

    def __init__(self, data_root: str, image_list: str, class_names: tuple,
                 ref_annots_root: str | None = None,
                 min_visib_fract: float = 0.0, digits: int = 5,
                 image_ext: str = "png"):
        super().__init__(data_root, image_list, class_names)
        self.ref_annots_root = ref_annots_root
        self.min_visib_fract = min_visib_fract
        self.digits = digits
        self.image_ext = image_ext
        self._ref_cache: dict[str, BopSequenceAnnots] = {}

    def _parse_path(self, rel_path: str):
        """'track_01/00001' or 'track_01/rgb/00001.png' → parts."""
        rel = rel_path.strip()
        parts = rel.split("/")
        if len(parts) == 2:  # image_set style: track/file-id
            seq, stem = parts
            img_id = int(stem)
            path = osp.join(self.data_root, seq, "rgb",
                            f"{img_id:0{self.digits}d}.{self.image_ext}")
        else:
            seq = parts[-3]
            img_id = int(osp.splitext(parts[-1])[0])
            path = osp.join(self.data_root, rel)
        return seq, img_id, path

    def _ref_annots(self, sequence: str) -> BopSequenceAnnots:
        if sequence not in self._ref_cache:
            self._ref_cache[sequence] = BopSequenceAnnots(
                self.ref_annots_root, sequence, with_info=False)
        return self._ref_cache[sequence]

    def get(self, index: int, rng: np.random.Generator | None = None
            ) -> dict | None:
        """``self[index]``; ``rng`` is unused (every object is kept)."""
        return self[index]

    def __getitem__(self, index: int) -> dict | None:
        seq, img_id, img_path = self._parse_path(self.img_files[index])
        annots = self._sequence_annots(self.data_root, seq)
        gt_pose, cam, infos = annots.annots_for(img_id)

        rs, ts, labels, mask_paths = [], [], [], []
        for i, obj in enumerate(gt_pose):
            info = infos[i] if infos is not None else None
            keep, label = self._keep_object(obj["obj_id"], info,
                                            self.min_visib_fract)
            if not keep:
                continue
            rs.append(np.asarray(obj["cam_R_m2c"], np.float32).reshape(3, 3))
            ts.append(np.asarray(obj["cam_t_m2c"], np.float32).reshape(3))
            labels.append(label)
            mask_paths.append(osp.join(
                self.data_root, seq, "mask_visib",
                f"{img_id:0{self.digits}d}_{i:06d}.png"))
        if not labels:
            return None

        k = np.asarray(cam["cam_K"], np.float32).reshape(3, 3)
        n = len(labels)
        image = imread(img_path)
        masks = []
        for mp in mask_paths:
            try:
                masks.append(imread(mp, gray=True) > 0)
            except (FileNotFoundError, OSError):
                masks.append(np.zeros(image.shape[:2], bool))

        out = {
            "image": image,
            "img_path": img_path,
            "scene_id": int(seq.split("_")[-1]) if "_" in seq else 0,
            "img_id": img_id,
            "gt_rotations": np.stack(rs),
            "gt_translations": np.stack(ts),
            "gt_masks": np.stack(masks),
            "labels": np.asarray(labels, np.int64),
            "k": np.repeat(k[None], n, axis=0),
            "ori_k": k,
        }
        if self.ref_annots_root is not None:
            ref_pose, _, _ = self._ref_annots(seq).annots_for(img_id)
            ref_rs, ref_ts, ref_labels = [], [], []
            for obj in ref_pose:
                keep, label = self._keep_object(obj["obj_id"], None)
                if not keep:
                    continue
                ref_rs.append(np.asarray(obj["cam_R_m2c"], np.float32)
                              .reshape(3, 3))
                ref_ts.append(np.asarray(obj["cam_t_m2c"], np.float32)
                              .reshape(3))
                ref_labels.append(label)
            out["ref_rotations"] = (np.stack(ref_rs) if ref_rs
                                    else np.zeros((0, 3, 3), np.float32))
            out["ref_translations"] = (np.stack(ref_ts) if ref_ts
                                       else np.zeros((0, 3), np.float32))
            out["ref_labels"] = np.asarray(ref_labels, np.int64)
        return out
