"""Evaluation with on-device ADD(-S) accumulation (port of
``scflow_tpu/training/evaluate.py:274-330``): refine padded batches whose
predictions line up with the GT slot for slot (jittered-GT synthetic
batches, scene batches) and accumulate masked ADD(-S) errors on the
device; the host reads the accumulator once, at the end.

The packed eval over a BOP test split (``pack_eval_batches``,
``evaluate_dataset``, the pose-graph pass) comes with the data slice.
"""
from __future__ import annotations

from collections.abc import Callable, Iterable

import torch

from ..geometry.se3 import add_error, adds_error
from ..parallel.collect import MetricAccumulator
from .points_bank import PointsBank
from .steps import _to_device


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
