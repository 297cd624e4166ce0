"""Fixed-shape per-class accumulation of pose errors (port of
``MetricAccumulator``, ``scflow_tpu/parallel/collect.py:45-125``), for one
process: ``update`` adds on the device with ``index_add_`` and never
waits for it; ``compute`` reads the counts back once and finishes in
numpy. Merging states across processes is a sum (the JAX package's psum),
which comes with data-parallel training."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class MetricAccumulator:
    """Per class: the instance count, the counts under each ADD threshold
    (a fraction of the mesh diameter) and a histogram of errors in mm for
    the AUC, as int32 tensors, so states merge by summation."""
    num_classes: int
    thresholds: tuple = (0.05, 0.10, 0.20, 0.50)
    auc_bins: int = 100
    max_auc_error: float = 100.0

    def init(self, device: str | torch.device = "cuda") -> dict:
        c, t, b = self.num_classes, len(self.thresholds), self.auc_bins
        return {
            "count": torch.zeros((c,), dtype=torch.int32, device=device),
            "under_threshold": torch.zeros((c, t), dtype=torch.int32,
                                           device=device),
            "auc_hist": torch.zeros((c, b), dtype=torch.int32, device=device),
        }

    def update(self, state: dict, labels: torch.Tensor, errors: torch.Tensor,
               diameters: torch.Tensor,
               valid: torch.Tensor | None = None) -> dict:
        """Add a batch of per-instance errors in place: labels (N,), errors
        (N,) in mm, diameters (N,), valid (N,) 0/1 (padded slots 0).
        Returns ``state``."""
        labels = labels.long()
        keep = (torch.ones_like(errors, dtype=torch.bool) if valid is None
                else valid > 0.5)
        one = keep.to(torch.int32)
        state["count"].index_add_(0, labels, one)
        rel = errors / diameters
        thr = torch.tensor(self.thresholds, dtype=rel.dtype, device=rel.device)
        hits = (keep[:, None] & (rel[:, None] < thr)).to(torch.int32)
        state["under_threshold"].index_add_(0, labels, hits)
        bins = (errors / self.max_auc_error * self.auc_bins).to(
            torch.int32).clamp(0, self.auc_bins - 1)
        state["auc_hist"].view(-1).index_add_(
            0, labels * self.auc_bins + bins, one)
        return state

    def merge(self, states: list) -> dict:
        """Sum accumulator states."""
        return {k: sum(s[k] for s in states) for k in states[0]}

    def compute(self, state: dict) -> dict:
        """Final per-class + average accuracies and histogram AUC."""
        count = state["count"].cpu().numpy().astype(np.float64)
        under = state["under_threshold"].cpu().numpy().astype(np.float64)
        hist = state["auc_hist"].cpu().numpy().astype(np.float64)
        present = count > 0
        safe = np.maximum(count, 1)
        out = {}
        accs = under / safe[:, None]
        for i, thr in enumerate(self.thresholds):
            out[f"average/add_{thr:.2f}d"] = float(accs[present, i].mean()
                                                   if present.any() else 0.0)
        # histogram AUC (midpoint rule): an error binned in bin i is taken
        # to lie at the bin centre, bracketing the exact step-function AUC
        # within ±0.5/auc_bins; auc_lo/auc_hi put every error at its bin's
        # right/left edge
        cum = np.cumsum(hist, axis=1) / safe[:, None]
        cum_lo = np.concatenate([np.zeros((cum.shape[0], 1)), cum[:, :-1]],
                                axis=1)
        aucs = (0.5 * (cum + cum_lo)).mean(axis=1)
        out["average/auc"] = float(aucs[present].mean() if present.any() else 0.0)
        out["average/auc_lo"] = float(cum_lo.mean(axis=1)[present].mean()
                                      if present.any() else 0.0)
        out["average/auc_hi"] = float(cum.mean(axis=1)[present].mean()
                                      if present.any() else 0.0)
        out["num_instances"] = int(count.sum())
        for c in range(self.num_classes):
            if present[c]:
                out[f"cls_{c}/auc"] = float(aucs[c])
        return out
