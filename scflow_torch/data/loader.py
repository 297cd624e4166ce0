"""Host-side batch assembly (port of ``scflow_tpu/data/loader.py``): train
batches of jittered, cropped and augmented objects (one per image, or
every object of a few images in padded slots), per-image eval crops of
every object at its reference pose, padding of an image's objects to a
fixed slot count, and a background-thread prefetcher.

Every batch is a dict of stacked numpy arrays in the JAX layout; the train
step uploads it, the eval loop (``training/evaluate.py``) packs several
images into one batch.

Deliberate differences from the JAX package, each so that no failure
passes quietly:

- A background file the port cannot decode (a form ``imageio``
  refuses, such as a CMYK JPEG) raises its ``ValueError``, naming the
  file, when the train builder is built; the JAX package skips a
  background it cannot read each time it draws it.
- An exception in a :func:`prefetch` worker is raised by the consumer;
  the JAX package's worker thread dies and the consumer waits forever.

Kept as the reference has it: the occluder reservoir stashes a crop
before drawing the occluder, so a crop can be pasted over itself.
"""
from __future__ import annotations

import atexit
import glob
import queue
import threading
from collections.abc import Iterator
from os import path as osp

import numpy as np

from ..training.config import Config
from .bop import RefineDataset, SuperviseTrainDataset
from .color_aug import (default_train_augs, random_background,
                        random_occlusion, random_occlusion_v2)
from .imageio import check_readable, imread
from .pipeline import (crop_resize_pad, crop_resize_pad_batch, expand_bbox,
                       jitter_pose_np, project_bbox)


class TrainBatchBuilder:
    """Build SCFlow train batches from a SuperviseTrainDataset (or any
    dataset with ``get(index, rng)``).

    Per object: jitter GT→ref pose, project keypoints for the ref bbox,
    crop/resize/pad around the ref bbox, adapt intrinsics, augment; stack
    into a fixed-size batch of uint8 crops (reference train pipeline,
    configs/refine_models/scflow_ycbv_pbr.py:46-89).
    """

    def __init__(self, dataset: SuperviseTrainDataset, cfg: Config,
                 mesh_points_per_class: list[np.ndarray],
                 mesh_diameters: list[float], seed: int = 0):
        self.dataset = dataset
        self.cfg = cfg
        self.mesh_points = mesh_points_per_class
        self.diameters = mesh_diameters
        self.rng = np.random.default_rng(seed)
        # background images for RandomBackground (reference
        # color_transform.py:176-244), decoded when drawn; each is checked
        # here so that one the port cannot decode fails now
        self._bg_paths: list[str] = []
        if cfg.data.background_dir:
            for ext in ("*.jpg", "*.png"):
                self._bg_paths += glob.glob(
                    osp.join(cfg.data.background_dir, ext))
            self._bg_paths.sort()
            for path in self._bg_paths:
                check_readable(path)
        # occluder reservoir for object-paste occlusion (RandomOcclusionV2
        # behavior): recent samples' pre-augmentation (patch, mask) pairs
        # serve as occluders for later samples
        self._occluder_pool: list[tuple[np.ndarray, np.ndarray]] = []
        self._occluder_pool_size = 16

    def _load_background(self) -> np.ndarray:
        paths = self._bg_paths
        return imread(paths[int(self.rng.integers(len(paths)))])

    def _one_sample(self) -> dict | None:
        idx = int(self.rng.integers(len(self.dataset)))
        # pass our own RNG: the dataset object is shared across prefetch
        # workers and numpy Generators are not thread-safe
        item = self.dataset.get(idx, self.rng)
        if item is None:
            return None
        # one object per crop (reference sample_num=1 recipe)
        i = int(self.rng.integers(len(item["labels"])))
        return self._prep_object(item, i)

    def _prep_object(self, item: dict, i: int) -> dict:
        """Jitter + crop + augment one object of a loaded image into a
        train sample."""
        label = int(item["labels"][i])
        gt_r = item["gt_rotations"][i]
        gt_t = item["gt_translations"][i]
        k = item["k"][i]

        ref_r, ref_t, add_err, trans_err, rot_err = jitter_pose_np(
            self.rng, gt_r, gt_t, self.cfg.jitter,
            mesh_points=self.mesh_points[label][:1000],
            mesh_diameter=self.diameters[label])

        bbox = project_bbox(self.mesh_points[label], k, ref_r, ref_t)
        size_ratio = self.rng.uniform(*self.cfg.data.crop_size_range)
        crop = crop_resize_pad(
            item["image"], bbox, k, self.cfg.data.image_scale,
            size_ratio=size_ratio, mask=item["gt_masks"][i])

        patch = crop.patch
        mask_patch = crop.mask_patch
        d = self.cfg.data
        if self._bg_paths and self.rng.uniform() < d.background_p:
            patch = random_background(self.rng, patch, mask_patch,
                                      [self._load_background()], p=1.1)
        if d.occlusion_v2_p > 0:
            # stash this crop as a future occluder BEFORE occluding it
            # (occluders must be clean object views), then paste one; the
            # draw can pick the crop just stashed (as in the reference)
            if mask_patch.any():
                pool = self._occluder_pool
                entry = (patch.copy(), mask_patch.copy())
                if len(pool) < self._occluder_pool_size:
                    pool.append(entry)
                else:
                    pool[int(self.rng.integers(len(pool)))] = entry
            if self._occluder_pool:
                occ_img, occ_mask = self._occluder_pool[
                    int(self.rng.integers(len(self._occluder_pool)))]
                patch, mask_patch = random_occlusion_v2(
                    self.rng, patch, mask_patch, occ_img, occ_mask,
                    p=d.occlusion_v2_p)
        if d.occlusion_p > 0:
            patch, mask_patch = random_occlusion(self.rng, patch, mask_patch,
                                                 p=d.occlusion_p)
        if d.color_aug:
            patch = default_train_augs(self.rng, patch)
        # raw uint8: the train step normalises on the device
        return {
            "real_images": np.ascontiguousarray(patch),
            "gt_masks": mask_patch.astype(np.uint8),
            "gt_rotations": gt_r, "gt_translations": gt_t,
            "ref_rotations": ref_r, "ref_translations": ref_t,
            "k": crop.k_new.astype(np.float32),
            "labels": np.int32(label),
            "init_add_error": np.float32(add_err),
            "init_rot_error": np.float32(rot_err),
            "init_trans_error": np.float32(trans_err),
        }

    def spawn(self, worker_id: int) -> "TrainBatchBuilder":
        """Clone with an independent RNG stream (for prefetch workers)."""
        clone = type(self)(self.dataset, self.cfg, self.mesh_points,
                           self.diameters)
        clone.rng = np.random.default_rng(
            [int(self.rng.integers(1 << 31)), worker_id])
        return clone

    def __call__(self) -> dict:
        samples = []
        while len(samples) < self.cfg.data.batch_size:
            s = self._one_sample()
            if s is not None:
                samples.append(s)
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class SceneTrainBatchBuilder(TrainBatchBuilder):
    """Scene-batched training: every visible object of each sampled image
    becomes an object slot; images' slots are padded to
    ``slots_per_image`` (copies of slot 0) and masked with
    ``sample_valid`` so the loss and the context encoder's BN statistics
    ignore the filler slots. The batch is (num_images × slots_per_image,
    ...); the dataset should keep every object (``sample_num=-1``)."""

    def __init__(self, dataset: SuperviseTrainDataset, cfg: Config,
                 mesh_points_per_class: list[np.ndarray],
                 mesh_diameters: list[float], seed: int = 0,
                 num_images: int = 4, slots_per_image: int = 4):
        super().__init__(dataset, cfg, mesh_points_per_class, mesh_diameters,
                         seed)
        self.num_images = num_images
        self.slots_per_image = slots_per_image

    def spawn(self, worker_id: int) -> "SceneTrainBatchBuilder":
        clone = SceneTrainBatchBuilder(
            self.dataset, self.cfg, self.mesh_points, self.diameters,
            num_images=self.num_images, slots_per_image=self.slots_per_image)
        clone.rng = np.random.default_rng(
            [int(self.rng.integers(1 << 31)), worker_id])
        return clone

    def _one_scene(self) -> list[dict] | None:
        idx = int(self.rng.integers(len(self.dataset)))
        item = self.dataset.get(idx, self.rng)
        if item is None:
            return None
        n = len(item["labels"])
        order = (self.rng.permutation(n)[:self.slots_per_image]
                 if n > self.slots_per_image else range(n))
        return [self._prep_object(item, int(i)) for i in order]

    def __call__(self) -> dict:
        scenes = []
        while len(scenes) < self.num_images:
            s = self._one_scene()
            if s:
                scenes.append(s)
        slots, valid = [], []
        for scene in scenes:
            pad = self.slots_per_image - len(scene)
            slots.extend(scene)
            slots.extend([scene[0]] * pad)      # filler: copy of slot 0
            valid.extend([1.0] * len(scene) + [0.0] * pad)
        batch = {k: np.stack([s[k] for s in slots]) for k in slots[0]}
        batch["sample_valid"] = np.asarray(valid, np.float32)
        return batch


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


class _WorkerError:
    """An exception raised in a prefetch worker, for the consumer to raise."""

    def __init__(self, error: BaseException):
        self.error = error


def prefetch(iterator_fn, num_prefetch: int = 4,
             num_workers: int = 3) -> Iterator[dict]:
    """Run ``iterator_fn()`` in background threads with a small queue and
    yield its batches. A callable with ``spawn`` (the train builders)
    gives each worker a clone with its own RNG (numpy Generators are not
    thread-safe); otherwise one worker calls it. numpy and zlib release
    the GIL for much of their work. An exception in a worker is raised
    here, in the consumer. Closing the generator stops the workers."""
    q: queue.Queue = queue.Queue(maxsize=num_prefetch)
    stop = threading.Event()

    num_workers = max(1, num_workers)
    if hasattr(iterator_fn, "spawn"):
        fns = [iterator_fn.spawn(i) for i in range(num_workers)]
    else:
        fns = [iterator_fn]

    def put(item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=1.0)
                return
            except queue.Full:
                continue

    def worker(fn):
        try:
            while not stop.is_set():
                put(fn())
        except Exception as e:   # handed to the consumer, which raises it
            put(_WorkerError(e))

    threads = [threading.Thread(target=worker, args=(fn,), daemon=True)
               for fn in fns]
    for th in threads:
        th.start()

    def _shutdown():
        stop.set()
        while True:          # drain so put() unblocks
            try:
                q.get_nowait()
            except queue.Empty:
                break
        for th in threads:
            th.join(timeout=2.0)

    atexit.register(_shutdown)
    try:
        while True:
            item = q.get()
            if isinstance(item, _WorkerError):
                raise item.error
            yield item
    finally:
        _shutdown()
        atexit.unregister(_shutdown)
