"""Evaluation loops (port of ``scflow_tpu/training/evaluate.py:33-105,
144-330``).

- :func:`evaluate_dataset` — the eval over a BOP test split: a thread pool
  decodes and crops images in dataset order (:func:`_prefetch_items`),
  :func:`pack_eval_batches` packs several images' objects into one
  fixed-shape batch of ``slot_budget`` slots, the device refines each
  batch, and the host matches predictions to GT per image (exact ADD(-S) /
  AUC / REP, ``metrics.ADDMetric``). Two batches stay in flight: each
  batch's poses go to pinned host memory by an asynchronous copy behind a
  CUDA event, and the host waits for that event only when it consumes the
  batch, so decode, crop and matching overlap the device.
- :func:`evaluate_device_accumulator` — refine padded batches whose
  predictions line up with the GT slot for slot (jittered-GT synthetic
  batches, scene batches) and accumulate masked ADD(-S) errors on the
  device; the host reads the accumulator once, at the end.

The scene pose-graph pass and the cross-process gather come with the
parallel slice.
"""
from __future__ import annotations

import itertools
from collections import deque
from collections.abc import Callable, Iterable
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..geometry.se3 import add_error, adds_error
from ..parallel.collect import MetricAccumulator
from .points_bank import PointsBank
from .steps import _to_device

EVAL_KEYS = ("real_images", "ref_rotations", "ref_translations", "k", "labels")


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


def _fetch_async(out: dict):
    """Start the device→host copy of a batch's poses: one concatenated
    (N, 12 or 13) f32 buffer copied without blocking into pinned memory,
    and a CUDA event after the copy; on the CPU the buffer itself and no
    event. Returns (host tensor, event or None)."""
    n = out["rotations"].shape[0]
    small = [out["rotations"].reshape(n, 9).float(),
             out["translations"].float()]
    if "pnp_valid" in out:
        small.append(out["pnp_valid"].float()[:, None])
    packed = torch.cat(small, dim=1)
    if packed.device.type != "cuda":
        return packed, None
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _unpack_outputs(small: np.ndarray, had_pnp: bool) -> dict:
    n = small.shape[0]
    out = {"rotations": small[:, :9].reshape(n, 3, 3),
           "translations": small[:, 9:12]}
    if had_pnp:
        out["pnp_valid"] = small[:, 12] > 0.5
    return out


def evaluate_dataset(trainer, builder, metric, *, slot_budget: int = 16,
                     limit: int | None = None, collect_results: bool = False,
                     progress_every: int = 50,
                     progress: Callable = print,
                     pose_graph_metric=None) -> tuple[dict, list]:
    """Batched eval over a TestBatchBuilder on the trainer's device.

    Packs images into ``slot_budget``-slot batches, refines each with
    ``trainer.predict(sync=False)``, matches predictions to GT per image on
    the host (``metric.process`` with the image's original K) and, with
    ``collect_results``, keeps each image's prediction for the BOP writer.
    The first ``limit`` images are evaluated. Returns ``(metric.compute(),
    results)``. ``pose_graph_metric`` (the scene pose-graph pass) is not
    ported yet and raises ``ValueError``.
    """
    if pose_graph_metric is not None:
        raise ValueError("the scene pose-graph pass is not ported yet")
    total = len(builder) if limit is None else min(limit, len(builder))
    indices = range(total)
    results = []
    n_images = 0
    packed = pack_eval_batches(_prefetch_items(builder, indices), slot_budget)

    def consume(host, event, had_pnp, metas):
        nonlocal n_images
        if event is not None:
            event.synchronize()             # this batch's copy, no later one
        out = _unpack_outputs(host.numpy(), had_pnp)
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
            n_images += 1
            if progress_every and n_images % progress_every == 0:
                progress(f"[{n_images}/{len(indices)}]", flush=True)

    # two-batch lag: the host consumes the oldest batch while the device
    # runs the two after it
    pending: deque = deque()
    for batch, metas in packed:
        out = trainer.predict({k: batch[k] for k in EVAL_KEYS},
                              keys=("rotations", "translations", "pnp_valid"),
                              sync=False)
        pending.append((*_fetch_async(out), "pnp_valid" in out, metas))
        if len(pending) > 2:
            consume(*pending.popleft())
    while pending:
        consume(*pending.popleft())
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

    @torch.inference_mode()
    def step(batch: dict, acc_state: dict) -> dict:
        out = eval_step(batch)
        batch = {k: _to_device(v, device) for k, v in batch.items()}
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
    with ``trainer.eval_step`` at the trainer's weights. Returns the
    accumulator's metric dict (thresholded accuracies, histogram AUC and
    its bracket)."""
    accumulator = MetricAccumulator(num_classes=num_classes)
    step = make_masked_metric_step(trainer.eval_step,
                                   points_bank.to(trainer.device),
                                   accumulator, device=trainer.device)
    state = accumulator.init(trainer.device)
    for batch in batches:
        state = step(batch, state)
    return accumulator.compute(state)
