"""Metric accumulation and the collectives of multi-process runs (port of
``scflow_tpu/parallel/collect.py``).

- :func:`reduce_metrics` — all-reduce SUM of a dict of tensors (the JAX
  package's ``psum``): one collective per dtype over a flat buffer.
- :func:`allgather_results` — every process's host arrays, concatenated
  in rank order along the leading axis.
- :func:`all_reduce_with_grad` — an all-reduce SUM whose backward is an
  all-reduce SUM, for statistics taken over the global batch inside a
  differentiated step (train-mode batch norm).
- :class:`MetricAccumulator` — fixed-shape per-class accumulation whose
  merge across processes is :func:`reduce_metrics` of its state.

Without a process group every collective is the identity.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from .mesh import is_distributed


def _all_reduce_sum(tensors: list) -> list:
    """SUM each tensor over the processes: new tensors, one all-reduce per
    dtype over their flattened concatenation."""
    out = list(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat)
        parts = flat.split([tensors[i].numel() for i in idx])
        for i, part in zip(idx, parts):
            out[i] = part.view(tensors[i].shape)
    return out


def reduce_metrics(tree: dict) -> dict:
    """All-reduce SUM of every tensor of ``tree`` (metric sums, accumulator
    states); without a process group, ``tree`` itself."""
    if not is_distributed():
        return tree
    keys = list(tree)
    return dict(zip(keys, _all_reduce_sum([tree[k].detach() for k in keys])))


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the processes, without a gradient (a loss's
    denominator over the global batch)."""
    if not is_distributed():
        return x
    return _all_reduce_sum([x.detach()])[0]


def all_reduce_grads_(grads: list) -> None:
    """Sum the gradients over the processes in place (one all-reduce)."""
    if is_distributed() and grads:
        torch._foreach_copy_(grads, _all_reduce_sum(grads))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        # every process's loss reads the sum, so the sum's gradient is the
        # sum of theirs
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_with_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the processes, differentiable: the gradient of
    each process's part is the summed gradient. Identity without a group."""
    return _AllReduceSum.apply(x) if is_distributed() else x


def allgather_results(local_tree: dict) -> dict:
    """Gather a dict of host arrays from every process: one process gets
    its input back; several get each key's arrays concatenated along the
    leading axis in rank order."""
    if not is_distributed():
        return local_tree
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, local_tree)
    return {k: np.concatenate([g[k] for g in gathered], axis=0)
            for k in local_tree}


@dataclasses.dataclass
class MetricAccumulator:
    """Per class: the instance count, the counts under each ADD threshold
    (a fraction of the mesh diameter) and a histogram of errors in mm for
    the AUC, as int32 tensors, so states merge by summation. ``update``
    adds on the device with ``index_add_`` and never waits for it;
    ``compute`` reads the counts back once and finishes in numpy."""
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
        Returns ``state``. The thresholds are compared as scalars: no
        tensor is made from host values, so nothing waits for the
        device."""
        labels = labels.long()
        keep = (torch.ones_like(errors, dtype=torch.bool) if valid is None
                else valid > 0.5)
        one = keep.to(torch.int32)
        state["count"].index_add_(0, labels, one)
        rel = errors / diameters
        under = torch.stack([rel < thr for thr in self.thresholds], dim=1)
        hits = (keep[:, None] & under).to(torch.int32)
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
