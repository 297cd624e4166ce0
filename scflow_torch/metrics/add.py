"""ADD(-S) pose-accuracy metric with per-class tables and a real AUC (a
numpy copy of ``scflow_tpu/metrics/add.py``: the port imports nothing of
the JAX package, not even its numpy modules).

Re-implementation of the reference evaluator (metrics/add.py): predictions
are matched to GT by class id (multi-candidate matches resolved by lowest
ADD, metrics/add.py:185-257), per-prediction ADD(-S) errors use sampled mesh
points with closest-point matching for symmetric classes (:354-400), and
accuracies are reported at {0.05, 0.10, 0.20, 0.50}×diameter plus the
**ADD AUC** — which the reference invokes but never defines (latent bug,
metrics/add.py:290; SURVEY.md §2.11): implemented here as the standard
PoseCNN/BOP area under the accuracy-vs-threshold curve up to
``max_error_mm`` (default 100 mm). 2D reprojection (REP) errors at
{2, 5, 10, 20} px are included.

Host-side numpy — eval aggregation is IO/bookkeeping, not a device hot path;
per-sample ADD errors can also be computed on the device with
``scflow_torch.geometry.add_error/adds_error``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

DEFAULT_ADD_THRESHOLDS = (0.05, 0.10, 0.20, 0.50)
DEFAULT_REP_THRESHOLDS = (2.0, 5.0, 10.0, 20.0)


def _transform(points, r, t):
    return points @ r.T + t


def add_error_np(points, r_pred, t_pred, r_gt, t_gt) -> float:
    p = _transform(points, r_pred, t_pred)
    g = _transform(points, r_gt, t_gt)
    return float(np.linalg.norm(p - g, axis=-1).mean())


def adds_error_np(points, r_pred, t_pred, r_gt, t_gt) -> float:
    p = _transform(points, r_pred, t_pred)
    g = _transform(points, r_gt, t_gt)
    d2 = (np.sum(g * g, -1)[:, None] + np.sum(p * p, -1)[None, :]
          - 2.0 * g @ p.T)
    return float(np.sqrt(np.maximum(d2.min(axis=-1), 0.0)).mean())


def rep_error_np(points, k, r_pred, t_pred, r_gt, t_gt) -> float:
    """Mean 2D reprojection error in pixels."""
    def proj(r, t):
        p = _transform(points, r, t) @ k.T
        return p[:, :2] / np.maximum(p[:, 2:3], 1e-8)

    return float(np.linalg.norm(proj(r_pred, t_pred) - proj(r_gt, t_gt),
                                axis=-1).mean())


def add_auc(errors_mm: np.ndarray, max_error_mm: float = 100.0) -> float:
    """Area under accuracy-vs-threshold (PoseCNN-style), errors in mm.

    accuracy(τ) = mean(err < τ); AUC = ∫₀^max acc(τ) dτ / max.
    """
    errs = np.sort(np.asarray(errors_mm, np.float64))
    n = len(errs)
    if n == 0:
        return 0.0
    # exact step-function integration: accuracy jumps to i/n at err_i
    xs = np.concatenate([[0.0], np.clip(errs, 0, max_error_mm),
                         [max_error_mm]])
    acc = np.concatenate([np.arange(n + 1) / n, [1.0]])
    widths = np.diff(xs)
    return float(np.sum(widths * acc[:len(widths)]) / max_error_mm)


def match_results(pred: dict, gt: dict, points_per_class, diameters,
                  symmetric_classes) -> list[dict]:
    """Match per-image predictions to GT by label; lowest-ADD wins ties.

    pred/gt dicts contain 'labels' (n,), 'rotations' (n,3,3),
    'translations' (n,3). Unmatched GT objects contribute worst-case errors
    (reference metrics/add.py:185-257 semantics).
    Returns a list of per-GT-object records.
    """
    records = []
    used_pred = set()
    for gi, glabel in enumerate(np.asarray(gt["labels"])):
        cands = [pi for pi, pl in enumerate(np.asarray(pred["labels"]))
                 if pl == glabel and pi not in used_pred]
        if not cands:
            records.append({"label": int(glabel), "matched": False})
            continue
        pts = points_per_class[int(glabel)]
        errs = [add_error_np(pts, pred["rotations"][pi],
                             pred["translations"][pi],
                             gt["rotations"][gi], gt["translations"][gi])
                for pi in cands]
        best = cands[int(np.argmin(errs))]
        used_pred.add(best)
        records.append({"label": int(glabel), "matched": True,
                        "pred_idx": best, "gt_idx": gi})
    return records


def eval_pose_errors(pred, gt, records, points_per_class, k=None):
    """Fill each matched record with add/adds/rep errors."""
    for rec in records:
        if not rec["matched"]:
            rec["add"] = rec["adds"] = rec["rep"] = np.inf
            continue
        pts = points_per_class[rec["label"]]
        pi, gi = rec["pred_idx"], rec["gt_idx"]
        args = (pts, pred["rotations"][pi], pred["translations"][pi],
                gt["rotations"][gi], gt["translations"][gi])
        rec["add"] = add_error_np(*args)
        rec["adds"] = adds_error_np(*args)
        if k is not None:
            rec["rep"] = rep_error_np(pts, k, *args[1:])
        else:
            rec["rep"] = np.inf
    return records


@dataclasses.dataclass
class ADDMetric:
    """Accumulating ADD(-S) evaluator (the mmengine ``ADD`` replacement).

    Usage: ``process(pred, gt)`` per image, then ``compute()`` → metric
    dict with per-class and average accuracies + AUC.

    Args:
      points_per_class: list/array of (P, 3) mesh points per class
        (reference samples 1000 verts from models_eval, metrics/add.py).
      diameters: (C,) mesh diameters in mm.
      symmetric_classes: class indices evaluated with ADD-S.
      class_names: optional names for reporting.
    """
    points_per_class: list
    diameters: np.ndarray
    symmetric_classes: tuple = ()
    class_names: tuple | None = None
    add_thresholds: tuple = DEFAULT_ADD_THRESHOLDS
    rep_thresholds: tuple = DEFAULT_REP_THRESHOLDS
    max_auc_error_mm: float = 100.0

    def __post_init__(self):
        self._records: list[dict] = []

    def reset(self):
        self._records = []

    def process(self, pred: dict, gt: dict, k: np.ndarray | None = None):
        """Accumulate one image's matched errors."""
        recs = match_results(pred, gt, self.points_per_class, self.diameters,
                             self.symmetric_classes)
        recs = eval_pose_errors(pred, gt, recs, self.points_per_class, k=k)
        self._records.extend(recs)

    def _metric_error(self, rec):
        """ADD-S for symmetric classes, ADD otherwise (metrics/add.py:386-394)."""
        return rec["adds"] if rec["label"] in self.symmetric_classes else rec["add"]

    def records_arrays(self) -> dict:
        """Pack accumulated records into dense arrays (for cross-process
        gather via ``allgather_results`` — the reference's collect_results
        pickle-funnel replacement, tools/eval.py:143-216). Unmatched
        records carry ``inf`` errors, so no flags are lost."""
        n = len(self._records)
        return {
            "labels": np.asarray([r["label"] for r in self._records],
                                 np.int64).reshape(n),
            "add": np.asarray([r["add"] for r in self._records],
                              np.float64).reshape(n),
            "adds": np.asarray([r["adds"] for r in self._records],
                               np.float64).reshape(n),
            "rep": np.asarray([r["rep"] for r in self._records],
                              np.float64).reshape(n),
        }

    def load_arrays(self, arrays: dict):
        """Replace the record list with (gathered) dense arrays."""
        self._records = [
            {"label": int(lb), "matched": bool(np.isfinite(a)),
             "add": float(a), "adds": float(s), "rep": float(rp)}
            for lb, a, s, rp in zip(arrays["labels"], arrays["add"],
                                    arrays["adds"], arrays["rep"])]

    def compute(self) -> dict:
        """Per-class + average accuracy table, AUC, REP accuracies."""
        if not self._records:
            return {}
        labels = sorted({r["label"] for r in self._records})
        out = {}
        all_errs, all_reps, all_aucs = [], [], []
        for lb in labels:
            recs = [r for r in self._records if r["label"] == lb]
            errs = np.asarray([self._metric_error(r) for r in recs])
            reps = np.asarray([r["rep"] for r in recs])
            diam = self.diameters[lb]
            name = (self.class_names[lb] if self.class_names else f"cls_{lb}")
            for thr in self.add_thresholds:
                out[f"{name}/add_{thr:.2f}d"] = float(
                    np.mean(errs < thr * diam))
            for thr in self.rep_thresholds:
                out[f"{name}/rep_{int(thr)}px"] = float(np.mean(reps < thr))
            auc = add_auc(errs, self.max_auc_error_mm)
            out[f"{name}/auc"] = auc
            all_errs.append(errs)
            all_reps.append(reps)
            all_aucs.append(auc)

        errs = np.concatenate(all_errs)
        reps = np.concatenate(all_reps)
        # average over classes (reference tables) and over instances
        for thr in self.add_thresholds:
            accs = [out[f"{(self.class_names[lb] if self.class_names else f'cls_{lb}')}/add_{thr:.2f}d"]
                    for lb in labels]
            out[f"average/add_{thr:.2f}d"] = float(np.mean(accs))
        for thr in self.rep_thresholds:
            accs = [out[f"{(self.class_names[lb] if self.class_names else f'cls_{lb}')}/rep_{int(thr)}px"]
                    for lb in labels]
            out[f"average/rep_{int(thr)}px"] = float(np.mean(accs))
        out["average/auc"] = float(np.mean(all_aucs))
        out["instance/auc"] = add_auc(errs, self.max_auc_error_mm)
        out["num_instances"] = len(self._records)
        return out


def format_metric_table(results: dict, class_names=None,
                        add_thresholds=(0.05, 0.10, 0.20, 0.50),
                        rep_thresholds=(2.0, 5.0, 10.0)) -> str:
    """Render the per-class accuracy table as aligned text (the reference's
    AsciiTable report, metrics/add.py:334-342)."""
    if not results:
        return "(no results)"
    classes = sorted({k.split("/")[0] for k in results
                      if "/" in k and not k.startswith(("average", "instance"))})
    add_cols = [f"add_{t:.2f}d" for t in add_thresholds]
    rep_cols = [f"rep_{int(t)}px" for t in rep_thresholds]
    cols = ["class"] + add_cols + rep_cols + ["auc"]
    rows = [cols]
    for c in classes + ["average"]:
        row = [c]
        for col in add_cols + rep_cols + ["auc"]:
            v = results.get(f"{c}/{col}")
            row.append("-" if v is None else f"{100 * v:.2f}")
        rows.append(row)
    widths = [max(len(r[i]) for r in rows) for i in range(len(cols))]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    lines = [sep]
    for i, r in enumerate(rows):
        lines.append("| " + " | ".join(v.ljust(w) for v, w in zip(r, widths))
                     + " |")
        if i == 0:
            lines.append(sep)
    lines.append(sep)
    if "instance/auc" in results:
        lines.append(f"instance AUC: {100 * results['instance/auc']:.2f}  "
                     f"({results.get('num_instances', 0)} instances)")
    return "\n".join(lines)
