"""Evaluation loops (port of ``scflow_tpu/training/evaluate.py``).

- :func:`evaluate_dataset` — the eval over a BOP test split: a thread pool
  decodes and crops images in dataset order (:func:`_prefetch_items`),
  :func:`pack_eval_batches` packs several images' objects into one
  fixed-shape batch of ``slot_budget`` slots, the device refines each
  batch, and the host matches predictions to GT per image (exact ADD(-S) /
  AUC / REP, ``metrics.ADDMetric``). Two batches stay in flight: each
  batch's poses go to pinned host memory by an asynchronous copy behind a
  CUDA event, and the host waits for that event only when it consumes the
  batch, so decode, crop and matching overlap the device. With a second
  metric, every image of 2 or more objects also goes through the scene
  pose graph on the device, right after its batch is refined
  (:func:`_pose_graph_refine`). Under a process group each process
  evaluates images ``rank::world`` and the metrics' records are gathered.
- :func:`evaluate_device_accumulator` — refine padded batches whose
  predictions line up with the GT slot for slot (jittered-GT synthetic
  batches, scene batches) and accumulate masked ADD(-S) errors on the
  device; the host reads the accumulator once, at the end (summed over
  the processes first).
"""
from __future__ import annotations

import itertools
from collections import deque
from collections.abc import Callable, Iterable
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.se3 import add_error, adds_error
from ..parallel.collect import (MetricAccumulator, allgather_results,
                                reduce_metrics)
from ..parallel.mesh import rank, world_size
from ..parallel.pose_graph import pose_graph_group, slot_targets
from ..utils.profiling import trace
from .points_bank import PointsBank
from .steps import _to_device

EVAL_KEYS = ("real_images", "ref_rotations", "ref_translations", "k", "labels")
# the batches ``evaluate_dataset(profile_dir=...)`` traces, after the first
PROFILED_BATCHES = 3


def _pad_slots(arrs: list[np.ndarray], budget: int) -> np.ndarray:
    """Stack per-object arrays and pad the slot axis with copies of slot 0."""
    stacked = np.concatenate(arrs, axis=0)
    n = stacked.shape[0]
    if n < budget:
        filler = np.tile(stacked[:1], (budget - n,) + (1,) * (stacked.ndim - 1))
        stacked = np.concatenate([stacked, filler], axis=0)
    return stacked


def pack_eval_batches(items: Iterable[dict], slot_budget: int):
    """Pack per-image eval items into fixed-shape batches.

    Each yielded value is ``(batch, metas)``: ``batch`` has ``slot_budget``
    object slots (keys real_images/ref_rotations/ref_translations/k/labels
    + sample_valid); ``metas`` is a list of ``(item, start, n)`` locating
    every packed image's slots. Images with more objects than the budget
    are truncated to the budget (reference batches are size-1 images;
    YCB-V never exceeds ~8 objects).
    """
    cur, metas, used = {k: [] for k in EVAL_KEYS}, [], 0
    for item in items:
        if item is None:
            continue
        n = min(len(item["labels"]), slot_budget)
        if used + n > slot_budget and used > 0:
            yield _finish_pack(cur, metas, used, slot_budget)
            cur, metas, used = {k: [] for k in EVAL_KEYS}, [], 0
        for k in EVAL_KEYS:
            v = np.asarray(item[k])
            cur[k].append(v[:n] if k != "labels" else
                          v[:n].astype(np.int32))
        metas.append((item, used, n))
        used += n
    if used > 0:
        yield _finish_pack(cur, metas, used, slot_budget)


def _finish_pack(cur, metas, used, budget):
    batch = {k: _pad_slots(cur[k], budget) for k in EVAL_KEYS}
    valid = np.zeros((budget,), np.float32)
    valid[:used] = 1.0
    batch["sample_valid"] = valid
    return batch, metas


def _prefetch_items(builder, indices, depth: int = 16, workers: int = 6):
    """Read builder items through a thread pool, yielding in dataset order:
    a window of ``depth`` items in flight across ``workers`` threads, so
    decodes and crops overlap each other and the device steps (zlib and
    numpy release the GIL for their heavy parts)."""
    it = iter(indices)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        window: deque = deque()
        for i in itertools.islice(it, depth):
            window.append(ex.submit(builder.__getitem__, i))
        while window:
            item = window.popleft().result()
            nxt = next(it, None)
            if nxt is not None:
                window.append(ex.submit(builder.__getitem__, nxt))
            yield item


def _pose_graph_refine(out: dict, batch: dict, metas: list, budget: int,
                       device: torch.device,
                       camera_only: bool = True) -> dict | None:
    """Scene pose-graph pass over a packed batch, on the device: every
    image of 2 or more objects is one group of slots, padded to ``budget``
    with copies of its first slot as the JAX package pads them (an image
    of one object passes through: its camera block is pure gauge). Each
    slot carries its own crop K. Returns the poses of every slot, refined
    where its image went through the graph, or None when no image has 2
    objects. The group indices go up through pinned memory without
    blocking."""
    groups = [(start, n) for _, start, n in metas if n >= 2]
    if not groups:
        return None
    rows = [[*range(start, start + n)] + [start] * (budget - n)
            for start, n in groups]
    valid = [[1.0] * n + [0.0] * (budget - n) for _, n in groups]
    slots = _to_device(np.asarray(rows, np.int64), device)
    valid = _to_device(np.asarray(valid, np.float32), device)
    k = _to_device(batch["k"], device)
    rotations = out["rotations"].float()
    translations = out["translations"].float()
    targets = slot_targets(out["flow"], out["masks"][..., 0], out["depth"],
                           out["ref_rotations"], out["ref_translations"], k)
    refined_r, refined_t = rotations.clone(), translations.clone()
    for i, (start, n) in enumerate(groups):
        pg = pose_graph_group(targets, rotations, translations, k, slots[i],
                              valid[i], camera_only=camera_only)
        refined_r[start:start + n] = pg["rotations"][:n]
        refined_t[start:start + n] = pg["translations"][:n]
    return {"rotations": refined_r, "translations": refined_t}


def _fetch_async(out: dict, refined: dict | None = None):
    """Start the device→host copy of a batch's poses: one concatenated
    (N, 12 or 13, + 12 with the pose graph's ``refined`` poses) f32 buffer
    copied without blocking into pinned memory, and a CUDA event after the
    copy; on the CPU the buffer itself and no event. Returns (host tensor,
    event or None)."""
    n = out["rotations"].shape[0]
    small = [out["rotations"].reshape(n, 9).float(),
             out["translations"].float()]
    if "pnp_valid" in out:
        small.append(out["pnp_valid"].float()[:, None])
    if refined is not None:
        small += [refined["rotations"].reshape(n, 9),
                  refined["translations"]]
    packed = torch.cat(small, dim=1)
    if packed.device.type != "cuda":
        return packed, None
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _unpack_outputs(small: np.ndarray, had_pnp: bool,
                    had_refined: bool) -> dict:
    n = small.shape[0]
    out = {"rotations": small[:, :9].reshape(n, 3, 3),
           "translations": small[:, 9:12]}
    if had_pnp:
        out["pnp_valid"] = small[:, 12] > 0.5
    if had_refined:
        i = 13 if had_pnp else 12
        out["pg_rotations"] = small[:, i:i + 9].reshape(n, 3, 3)
        out["pg_translations"] = small[:, i + 9:i + 12]
    return out


def _profiled(packed: Iterable, profile_dir: str | None, device):
    """The batches of ``packed``; with ``profile_dir``, the
    ``PROFILED_BATCHES`` after the first are refined and consumed under
    ``utils.profiling.trace(profile_dir)`` (spans on), which ends after a
    device synchronise, so that it holds their kernels."""
    items = iter(packed)
    if profile_dir is None:
        yield from items
        return
    yield from itertools.islice(items, 1)
    with trace(profile_dir):
        yield from itertools.islice(items, PROFILED_BATCHES)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    yield from items


def evaluate_dataset(trainer, builder, metric, *, slot_budget: int = 16,
                     limit: int | None = None, collect_results: bool = False,
                     progress_every: int = 50,
                     progress: Callable = print,
                     pose_graph_metric=None,
                     pose_graph_camera_only: bool = True,
                     profile_dir: str | None = None) -> tuple[dict, list]:
    """Batched eval over a TestBatchBuilder on the trainer's device.

    Packs images into ``slot_budget``-slot batches, refines each with
    ``trainer.predict(sync=False)``, matches predictions to GT per image on
    the host (``metric.process`` with the image's original K) and, with
    ``collect_results``, keeps each image's prediction for the BOP writer.
    The first ``limit`` images are evaluated. Returns ``(metric.compute(),
    results)``.

    ``pose_graph_metric``: images of 2 or more objects also go through the
    scene pose graph (a shared camera correction on flow-derived targets,
    :func:`_pose_graph_refine`, ``camera_only`` by default) and this
    second metric takes the refined poses (an image of one object: its
    poses as they are). Under a process group each process evaluates
    images ``rank::world`` and both metrics' records are gathered, so
    every process computes the metrics of all images; ``results`` stay
    per process. ``profile_dir``: the three batches after the first are
    traced into one Chrome trace there (:func:`_profiled`)."""
    total = len(builder) if limit is None else min(limit, len(builder))
    indices = range(rank(), total, world_size())
    results = []
    n_images = 0
    packed = pack_eval_batches(_prefetch_items(builder, indices), slot_budget)
    keys = ("rotations", "translations", "pnp_valid")
    if pose_graph_metric is not None:
        keys += ("flow", "masks", "depth", "ref_rotations", "ref_translations")

    def consume(host, event, had_pnp, had_refined, metas):
        nonlocal n_images
        if event is not None:
            event.synchronize()             # this batch's copy, no later one
        out = _unpack_outputs(host.numpy(), had_pnp, had_refined)
        for item, start, n in metas:
            pred = {"labels": np.asarray(item["labels"][:n]),
                    "rotations": out["rotations"][start:start + n],
                    "translations": out["translations"][start:start + n],
                    "scores": np.ones(n, np.float32)}
            if collect_results:
                results.append({"scene_id": item["scene_id"],
                                "img_id": item["img_id"], **pred})
            if "gt_rotations" in item:
                gt = {"labels": item["gt_labels"],
                      "rotations": item["gt_rotations"],
                      "translations": item["gt_translations"]}
                metric.process(pred, gt, k=item["ori_k"])
                if pose_graph_metric is not None:
                    if had_refined:
                        pred = dict(
                            pred, rotations=out["pg_rotations"][start:start + n],
                            translations=out["pg_translations"][start:start + n])
                    pose_graph_metric.process(pred, gt, k=item["ori_k"])
            n_images += 1
            if progress_every and n_images % progress_every == 0:
                progress(f"[{n_images}/{len(indices)}]", flush=True)

    # two-batch lag: the host consumes the oldest batch while the device
    # runs the two after it
    pending: deque = deque()
    for batch, metas in _profiled(packed, profile_dir,
                                  torch.device(trainer.device)):
        out = trainer.predict({k: batch[k] for k in EVAL_KEYS}, keys=keys,
                              sync=False)
        refined = None
        if pose_graph_metric is not None:
            refined = _pose_graph_refine(out, batch, metas, slot_budget,
                                         trainer.device,
                                         camera_only=pose_graph_camera_only)
        pending.append((*_fetch_async(out, refined), "pnp_valid" in out,
                        refined is not None, metas))
        if len(pending) > 2:
            consume(*pending.popleft())
    while pending:
        consume(*pending.popleft())
    for m in (metric, pose_graph_metric):
        if m is not None and world_size() > 1:
            m.load_arrays(allgather_results(m.records_arrays()))
    return metric.compute(), results


def pose_errors(rotations: torch.Tensor, translations: torch.Tensor,
                gt_rotations: torch.Tensor, gt_translations: torch.Tensor,
                labels: torch.Tensor, points_bank: PointsBank) -> torch.Tensor:
    """Per-sample ADD-S (symmetric classes) or ADD error in mm, (N,), over
    the class's bank points; padded points are replaced by the first
    point, which is valid, so they leave the mean unchanged."""
    points, point_valid, symmetric, _ = points_bank.gather(labels.long())
    pts = torch.where(point_valid[..., None], points, points[:, :1])
    add = add_error(rotations, translations, gt_rotations, gt_translations,
                    pts)
    adds = adds_error(rotations, translations, gt_rotations, gt_translations,
                      pts)
    return torch.where(symmetric, adds, add)


def make_masked_metric_step(eval_step: Callable, points_bank: PointsBank,
                            accumulator: MetricAccumulator,
                            device: str | torch.device = "cuda"):
    """Step ``(batch, acc_state) -> acc_state``: refine a padded batch with
    ``eval_step`` and add its masked ADD(-S) errors to the accumulator on
    ``device``, with no host sync. ``points_bank`` must be on ``device``."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def step(batch: dict, acc_state: dict) -> dict:
        out = eval_step(batch)
        batch = {k: _to_device(v, dev) for k, v in batch.items()}
        labels = batch["labels"].long()
        err = pose_errors(out["rotations"], out["translations"],
                          batch["gt_rotations"], batch["gt_translations"],
                          labels, points_bank)
        return accumulator.update(acc_state, labels, err,
                                  points_bank.diameters[labels],
                                  valid=batch.get("sample_valid"))

    return step


def evaluate_device_accumulator(trainer, batches: Iterable[dict],
                                points_bank: PointsBank,
                                num_classes: int) -> dict:
    """Masked ADD(-S) eval on the trainer's device over padded batches
    carrying gt_rotations / gt_translations and optionally sample_valid,
    with ``trainer.eval_step`` at the trainer's weights; under a process
    group each process brings its own batches and the states are summed
    before ``compute``. Returns the accumulator's metric dict
    (thresholded accuracies, histogram AUC and its bracket)."""
    accumulator = MetricAccumulator(num_classes=num_classes)
    step = make_masked_metric_step(trainer.eval_step,
                                   points_bank.to(trainer.device),
                                   accumulator, device=trainer.device)
    state = accumulator.init(trainer.device)
    for batch in batches:
        state = step(batch, state)
    return accumulator.compute(reduce_metrics(state))
