"""What the metric readers (``metrics/<name>.py``) share: each returns a
number from a run's record, or None where the record holds nothing for
it (another kind of step, an untraced run, no such kernel)."""
from __future__ import annotations

import statistics

STEPS = {"refine": "eval", "train": "train"}


def window_rate(rec: dict, step: str):
    """Objects or samples over the whole window ÷ the window's seconds."""
    if rec["step"] != STEPS[step]:
        return None
    return rec["steps"] * rec["batch"] / rec["window_s"]


def step_quantile_ms(rec: dict, step: str, q: int):
    """The q-th percentile of the window's step times (≥ 10 steps)."""
    if rec["step"] != STEPS[step] or len(rec["step_s"]) < 10:
        return None
    return 1e3 * statistics.quantiles(rec["step_s"], n=100)[q - 1]


def _traced(rec: dict, step: str):
    t = rec.get("trace")
    return t if t is not None and rec["step"] == STEPS[step] else None


def layer_ms(rec: dict, step: str, layers: tuple):
    """Device ms a step of the layers' kernels in the layer trace."""
    t = _traced(rec, step)
    if t is None:
        return None
    us = sum(t["layers_us"].get(layer, 0.0) for layer in layers)
    return us * 1e-3 / t["layer_steps"] if us > 0 else None


def launches(rec: dict, step: str):
    t = _traced(rec, step)
    return None if t is None else t["plain"]["launches"] / t["plain"]["steps"]


def idle_pct(rec: dict, step: str):
    t = _traced(rec, step)
    if t is None:
        return None
    p = t["plain"]
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def roofline_pct(rec: dict, step: str, kinds: tuple, bound: str):
    """The kernels' least time (the bound of their work at the card's
    peaks) as a share of their device time in the plain trace."""
    t = _traced(rec, step)
    if t is None:
        return None
    seconds = sum(t["plain"]["kind_s"].get(k, 0.0) for k in kinds)
    return 100.0 * t[bound] / seconds if seconds > 0 else None


def mfu_pct(rec: dict, step: str):
    """The reference's FLOPs of the window's steps ÷ the window's seconds
    on the host's clock ÷ the card's f32 peak (read in traced runs, which
    hold the FLOPs count)."""
    t = _traced(rec, step)
    if t is None:
        return None
    return (100.0 * t["flops_per_step"] * rec["steps"] / rec["window_s"]
            / t["peak_flops"])
