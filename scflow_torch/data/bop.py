"""BOP-format dataset readers, host-side numpy (port of
``scflow_tpu/data/bop.py:22-25, 53-130, 212-280``).

:class:`RefineDataset` pairs eval/test images with externally supplied
initial poses, e.g. PoseCNN's (reference datasets/refine.py). The BOP
layout per sequence directory ``XXXXXX/``: ``rgb/``, ``mask_visib/``,
``scene_gt.json``, ``scene_gt_info.json``, ``scene_camera.json``; image
lists are text files of ``sequence/rgb/XXXXXX.png`` paths. Images are read
by the port's PNG decoder (``data.imageio``), not cv2 or PIL. The training
readers (``SuperviseTrainDataset``, ``ConcatDataset``) come with the
training-data slice.
"""
from __future__ import annotations

import json
from os import path as osp

import numpy as np

from .imageio import imread


def _load_json(path):
    with open(path) as f:
        return json.load(f)


class BopSequenceAnnots:
    """Lazy per-sequence BOP json bundle (pose / camera / gt_info)."""

    def __init__(self, root: str, sequence: str, with_info: bool = True):
        seq_dir = osp.join(root, sequence)
        self.pose = _load_json(osp.join(seq_dir, "scene_gt.json"))
        cam_path = osp.join(seq_dir, "scene_camera.json")
        # initial-pose roots (e.g. PoseCNN results) carry only scene_gt.json
        self.camera = _load_json(cam_path) if osp.exists(cam_path) else None
        info_path = osp.join(seq_dir, "scene_gt_info.json")
        self.info = _load_json(info_path) if (with_info and osp.exists(info_path)) else None

    @staticmethod
    def _get(d, img_id: int):
        if str(img_id) in d:
            return d[str(img_id)]
        return d[f"{img_id:06d}"]

    def annots_for(self, img_id: int):
        pose = self._get(self.pose, img_id)
        cam = self._get(self.camera, img_id) if self.camera is not None else None
        info = self._get(self.info, img_id) if self.info is not None else None
        return pose, cam, info


def read_image_list(path: str) -> list[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


class BaseBopDataset:
    """Shared image-list + annotation loading."""

    def __init__(self, data_root: str, image_list: str,
                 class_names: tuple, label_mapping: dict | None = None,
                 target_labels: list | None = None):
        self.data_root = data_root
        self.class_names = class_names
        self.label_mapping = label_mapping
        self.target_labels = target_labels
        self.img_files = read_image_list(image_list)
        self._annots_cache: dict[str, BopSequenceAnnots] = {}

    def __len__(self):
        return len(self.img_files)

    def _sequence_annots(self, root: str, sequence: str) -> BopSequenceAnnots:
        key = f"{root}/{sequence}"
        if key not in self._annots_cache:
            self._annots_cache[key] = BopSequenceAnnots(root, sequence)
        return self._annots_cache[key]

    def _parse_path(self, rel_path: str):
        """'000048/rgb/000001.png' → (sequence '000048', img_id 1, abs path)."""
        parts = rel_path.split("/")
        seq = parts[-3]
        img_id = int(osp.splitext(parts[-1])[0])
        return seq, img_id, osp.join(self.data_root, rel_path)

    def _keep_object(self, obj_id: int, info: dict | None,
                     min_visib_fract: float = 0.0,
                     min_visib_px: int = 0) -> tuple[bool, int]:
        """Apply label mapping/filtering; returns (keep, mapped 0-based label)."""
        if self.target_labels is not None and obj_id not in self.target_labels:
            return False, -1
        if self.label_mapping is not None:
            if obj_id not in self.label_mapping:
                return False, -1
            obj_id = self.label_mapping[obj_id]
        if info is not None:
            if info.get("visib_fract", 1.0) < min_visib_fract:
                return False, -1
            if info.get("px_count_visib", 1 << 30) < min_visib_px:
                return False, -1
        return True, obj_id - 1


class RefineDataset(BaseBopDataset):
    """Eval/test dataset pairing reference (initial) poses with GT.

    ``ref_annots_root`` holds BOP-style scene_gt.json files with the initial
    poses (e.g. PoseCNN results), like the reference RefineDataset
    (datasets/refine.py:75-213). Predictions are matched to GT by obj_id.
    """

    def __init__(self, data_root: str, ref_annots_root: str, image_list: str,
                 class_names: tuple, label_mapping=None, target_labels=None,
                 load_gt: bool = True):
        super().__init__(data_root, image_list, class_names, label_mapping,
                         target_labels)
        self.ref_annots_root = ref_annots_root
        self.load_gt = load_gt
        self._ref_cache: dict[str, BopSequenceAnnots] = {}

    def _ref_annots(self, sequence: str) -> BopSequenceAnnots:
        if sequence not in self._ref_cache:
            self._ref_cache[sequence] = BopSequenceAnnots(
                self.ref_annots_root, sequence, with_info=False)
        return self._ref_cache[sequence]

    def __getitem__(self, index: int) -> dict | None:
        seq, img_id, img_path = self._parse_path(self.img_files[index])
        ref = self._ref_annots(seq)
        ref_pose, _, _ = ref.annots_for(img_id)

        rs, ts, labels = [], [], []
        for obj in ref_pose:
            keep, label = self._keep_object(obj["obj_id"], None)
            if not keep:
                continue
            rs.append(np.asarray(obj["cam_R_m2c"], np.float32).reshape(3, 3))
            ts.append(np.asarray(obj["cam_t_m2c"], np.float32).reshape(3))
            labels.append(label)
        if not labels:
            return None

        gt = self._sequence_annots(self.data_root, seq)
        _, cam, _ = gt.annots_for(img_id)
        k = np.asarray(cam["cam_K"], np.float32).reshape(3, 3)
        n = len(labels)

        out = {
            "image": imread(img_path),
            "img_path": img_path,
            "scene_id": int(seq),
            "img_id": img_id,
            "ref_rotations": np.stack(rs),
            "ref_translations": np.stack(ts),
            "labels": np.asarray(labels, np.int64),
            "k": np.repeat(k[None], n, axis=0),
            "ori_k": k,
        }
        if self.load_gt:
            gt_pose, _, _ = gt.annots_for(img_id)
            gt_rs, gt_ts, gt_labels = [], [], []
            for obj in gt_pose:
                keep, label = self._keep_object(obj["obj_id"], None)
                if not keep:
                    continue
                gt_rs.append(np.asarray(obj["cam_R_m2c"], np.float32).reshape(3, 3))
                gt_ts.append(np.asarray(obj["cam_t_m2c"], np.float32).reshape(3))
                gt_labels.append(label)
            out["gt_rotations"] = np.stack(gt_rs) if gt_rs else np.zeros((0, 3, 3), np.float32)
            out["gt_translations"] = np.stack(gt_ts) if gt_ts else np.zeros((0, 3), np.float32)
            out["gt_labels"] = np.asarray(gt_labels, np.int64)
        return out
