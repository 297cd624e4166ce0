"""The span trace: where the host is while the device works or waits.

The port marks parts of its step with spans (``scflow_torch.utils.
profiling.span``: ``step``, ``inputs``, ``render``, ``encode``,
``decoder``, ``decoder.iter``, ``pnp``, ``backward``, ``optimizer``),
each a ``record_function`` range named ``PREFIX + name`` while spans are
on and nothing at all while they are off. A span trace records, in one
profiler session and so on one clock, the device's activity, the CUDA
runtime calls of the host and the spans alone: the CPU activity is kept
to user-scope ranges where the torch build takes a ``scopes`` argument
(``scopes`` in the summary says which was used), so no op is recorded.
From it, per span name:

- ``count`` and ``host_us``: how often the span was opened and the sum
  of its intervals on the host;
- ``self`` and ``total``: ``launches`` (the runtime's kernel-launch
  calls, ``LAUNCH_CALLS``, at each call's start on the host), ``syncs``
  (blocking calls, ``SYNC_CALLS``) and ``idle_us`` (the device's idle
  gaps, found as ``trace.summarize_plain`` finds them and split over
  time by the span open on the host at each instant), where ``self``
  credits the innermost open span alone and ``total`` every open span of
  the name.

What falls in no span goes under ``outside`` (the caller between steps).
``device_ops`` counts the device's kernels, copies and sets (what the
plain trace's ``launches`` counts); ``host_calls`` the commonest runtime
calls by name. The spans of all threads are one timeline, so a launch
from the autograd thread during ``backward`` is credited to
``backward``.

``take`` traces ``steps`` calls of a step with spans on, retaken as
``trace.take`` retakes, until the trace holds the hand-written kernels
the port's counters say ran. ``read`` turns a run's record into the
per-layer numbers (None for an untraced record or one without spans).

A traced run's span trace is taken once, by ``of``, when the first of
its readers asks: after the run's own traces and check, which ran with
spans off, in a process of its own (a fresh profiler; ``TIMEOUT_S``)
that sets the run's cell up again from the run's seed and traces
``trace_steps`` steps:

    python3 portbench/span_trace.py --workload <cell> --seed <n>
        --turns 0 --plain 0

Its table goes to this run's standard error and its summary into
``record["trace"]["spans"]``. A port without spans (no ``enable_spans``)
gets None and no such process. Run by hand, the script also measures
windows with spans off and on in turns and a plain trace."""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import subprocess
import sys
import time

import torch

from . import readers, trace

PREFIX = "scflow.span:"
OUTSIDE = "outside"
STEP = "step"
ITER = "decoder.iter"
# the CUDA calls that launch a kernel
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
# the runtime calls that block the host until the device has caught up
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
METRICS = ("step_dispatch_ms", "gru_iter_dispatch_ms", "gru_iter_launches",
           "host_syncs_per_step", "idle_in_step_pct")
COUNTS = ("launches", "syncs", "idle_us")
SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "span_trace.py")
# a span trace's process: set-up, warm-up and at most ``trace.TRIES``
# traces (20-40 s on an H100)
TIMEOUT_S = 300


def _profile(fn, steps: int):
    """(raw profiler events, wall seconds, scopes) of ``steps`` calls of
    ``fn``: the device's activity and the host's user-scope ranges."""
    from torch._C._profiler import (ProfilerActivity, RecordScope,
                                    _ExperimentalConfig)
    from torch.autograd import (ProfilerConfig, ProfilerState,
                                _disable_profiler, _enable_profiler,
                                _prepare_profiler)

    config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                            False, _ExperimentalConfig())
    activities = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
    torch.cuda.synchronize()
    _prepare_profiler(config, activities)
    try:
        _enable_profiler(config, activities, {RecordScope.USER_SCOPE})
        scopes = "user"
    except TypeError:           # a torch without the scopes argument
        _enable_profiler(config, activities)
        scopes = "all"
    try:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        result = _disable_profiler()
    return result.events(), wall, scopes


def events_of(raw) -> tuple[list, list, list]:
    """(spans [(start µs, end µs, name)], device ops [(start µs, end µs)],
    host runtime calls [(start µs, name)]) of raw profiler events."""
    cuda = torch.autograd.DeviceType.CUDA
    spans, ops, calls = [], [], []
    for e in raw:
        name = e.name()
        if e.device_type() == cuda:
            if (e.is_user_annotation() or name in trace.NOT_KERNELS
                    or name.startswith((PREFIX, trace.PREFIX))):
                continue
            ops.append((e.start_ns() * 1e-3, e.end_ns() * 1e-3))
        elif name.startswith(PREFIX):
            spans.append((e.start_ns() * 1e-3, e.end_ns() * 1e-3,
                           name[len(PREFIX):]))
        elif not e.is_user_annotation() and name.startswith(("cuda", "cu")):
            calls.append((e.start_ns() * 1e-3, name))
    return spans, ops, calls


class Timeline:
    """The spans open on the host at each instant: ``at(t)`` gives (the
    innermost span's name or None, the names of every open span), and
    ``split(t0, t1)`` the pieces of [t0, t1] as (µs, innermost, names).
    The innermost span is the open one that started last."""

    def __init__(self, spans: list):
        spans = [s for s in spans if s[1] > s[0]]
        marks = sorted([(e, 0, i) for i, (_, e, _) in enumerate(spans)]
                       + [(s, 1, i) for i, (s, _, _) in enumerate(spans)])
        open_, self.starts, self.states = {}, [], []
        for t, opening, i in marks:
            if opening:
                open_[i] = spans[i]
            else:
                open_.pop(i)
            inner = (max(open_.values(), key=lambda s: (s[0], -s[1]))[2]
                     if open_ else None)
            state = (inner, frozenset(s[2] for s in open_.values()))
            if self.starts and self.starts[-1] == t:
                self.states[-1] = state
            else:
                self.starts.append(t)
                self.states.append(state)

    def at(self, t: float) -> tuple:
        i = bisect.bisect_right(self.starts, t) - 1
        return self.states[i] if i >= 0 else (None, frozenset())

    def split(self, t0: float, t1: float):
        i = bisect.bisect_right(self.starts, t0) - 1
        at = t0
        while at < t1:
            end = (min(t1, self.starts[i + 1]) if i + 1 < len(self.starts)
                   else t1)
            yield (end - at, *(self.states[i] if i >= 0
                               else (None, frozenset())))
            at = end
            i += 1


def summarize(spans: list, ops: list, calls: list, steps: int,
              wall: float) -> dict:
    """The span trace's numbers (see the module's docstring)."""
    line = Timeline(spans)
    by_span = {}
    for s, e, name in spans:
        entry = by_span.setdefault(name, {
            "count": 0, "host_us": 0.0,
            "self": dict.fromkeys(COUNTS, 0), "total": dict.fromkeys(
                COUNTS, 0)})
        entry["count"] += 1
        entry["host_us"] += e - s
    outside = dict.fromkeys(COUNTS, 0)

    def credit(key, amount, inner, names):
        (by_span[inner]["self"] if inner else outside)[key] += amount
        for name in names:
            by_span[name]["total"][key] += amount

    n = dict.fromkeys(("launches", "syncs"), 0)
    for t, name in calls:
        key = ("launches" if name in LAUNCH_CALLS
               else "syncs" if name in SYNC_CALLS else None)
        if key:
            n[key] += 1
            credit(key, 1, *line.at(t))
    busy, gaps, idle = 0.0, [], 0.0
    if ops:
        busy, gaps = trace._busy_and_gaps(ops, min(o[0] for o in ops),
                                          max(o[1] for o in ops))
    for g0, g1 in gaps:
        idle += g1 - g0
        for us, inner, names in line.split(g0, g1):
            credit("idle_us", us, inner, names)
    return {"steps": steps, "wall_s": wall, **n, "device_ops": len(ops),
            "busy_us": busy, "idle_us": idle, "outside": outside,
            "by_span": by_span, "host_calls": dict(collections.Counter(
                name for _, name in calls).most_common(12))}


def metrics(summary: dict) -> dict:
    """The per-layer numbers of a summary: host ms a step inside ``step``,
    host ms and launches of one ``decoder.iter``, blocking calls a step
    inside ``step``, and the share of the device's idle time during
    which the host was inside ``step`` (%); None where a span is absent."""
    spans, k = summary["by_span"], summary["steps"]
    step, it = spans.get(STEP), spans.get(ITER)
    return {
        "step_dispatch_ms": step["host_us"] * 1e-3 / k if step else None,
        "gru_iter_dispatch_ms": (it["host_us"] * 1e-3 / it["count"]
                                 if it else None),
        "gru_iter_launches": (it["total"]["launches"] / it["count"]
                              if it else None),
        "host_syncs_per_step": step["total"]["syncs"] / k if step else None,
        "idle_in_step_pct": (100.0 * step["total"]["idle_us"]
                             / summary["idle_us"]
                             if step and summary["idle_us"] > 0 else None),
    }


def accounting(summary: dict) -> dict:
    """The checks of a summary's books: launches and idle µs by span
    (innermost) plus ``outside`` against the trace's, as relative gaps,
    and the share of launches inside ``step``."""
    spans, out = summary["by_span"], summary["outside"]
    gaps = {}
    for key, whole in (("launches", summary["launches"]),
                       ("idle_us", summary["idle_us"])):
        parts = sum(s["self"][key] for s in spans.values()) + out[key]
        gaps[key] = abs(parts - whole) / whole if whole else 0.0
    step = spans.get(STEP)
    in_step = (step["total"]["launches"] / summary["launches"]
               if step and summary["launches"] else None)
    return {"launches_gap": gaps["launches"], "idle_gap": gaps["idle_us"],
            "launches_in_step": in_step}


def _run_args() -> argparse.Namespace:
    """The cell and seed of ``portbench/run.py``'s command line."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    return ap.parse_known_args(sys.argv[1:])[0]


def _port_has_spans() -> bool:
    """Whether the port this run loaded (``core/program.py``) has the
    switch of its spans."""
    return hasattr(sys.modules.get("scflow_torch.utils.profiling"),
                   "enable_spans")


def _span_trace(cell: str):
    """The summary of a span trace of ``cell`` at this run's seed, from a
    process of its own; None without a card, outside a run of ``cell``
    or where the port has no spans."""
    args = _run_args()
    if (args.workload != cell or args.seed is None
            or not torch.cuda.is_available() or not _port_has_spans()):
        return None
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, SCRIPT, "--workload", cell, "--seed",
         str(args.seed), "--turns", "0", "--plain", "0"],
        cwd=os.path.dirname(os.path.dirname(SCRIPT)), capture_output=True,
        text=True, timeout=TIMEOUT_S)
    sys.stderr.write(proc.stderr)
    print(f"span trace of {cell}: {time.perf_counter() - t0:.1f} s in a "
          f"process of its own", file=sys.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"the span trace of {cell} exited with code "
                           f"{proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])["spans"]


def of(rec: dict):
    """The span trace's summary of a traced run's record, taken on the
    first call and kept in ``record["trace"]["spans"]``."""
    t = rec["trace"]
    if "spans" not in t:
        t["spans"] = _span_trace(rec["cell"])
    return t["spans"]


def read(rec: dict, metric: str, step: str):
    """``metric`` (one of ``METRICS``) of a run's record, for a
    ``refine`` or ``train`` reader; None for another kind of step, an
    untraced run or a port without spans."""
    if rec.get("trace") is None or rec["step"] != readers.STEPS[step]:
        return None
    summary = of(rec)
    return None if summary is None else metrics(summary)[metric]


def _kernels_of(raw) -> collections.Counter:
    """The hand-written kernels by name in raw profiler events."""
    seen = collections.Counter()
    for e in raw:
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation()):
            short = trace._short(e.name())
            if short:
                seen[short] += 1
    return seen


def take(fn, steps: int, counts, enable) -> dict:
    """The summary of ``steps`` calls of ``fn`` traced with spans on
    (``enable(flag)``, the port's switch, which returns the state it
    replaces), retaken up to ``trace.TRIES`` times until the trace holds
    the hand-written kernels ``counts()`` says ran; spans are as they
    were after it, whatever happens."""
    was = enable(True)
    try:
        for _ in range(trace.TRIES):
            before = counts()
            raw, wall, scopes = _profile(fn, steps)
            if _kernels_of(raw) == trace.expected_kernels(before, counts()):
                out = summarize(*events_of(raw), steps, wall)
                out["scopes"] = scopes
                return out
            del raw
    finally:
        enable(was)
    raise RuntimeError("every span trace lost hand-written kernels that "
                       "the port's counters say were launched")


def table(summary: dict) -> str:
    """The per-span table: count, host ms, and launches, syncs and idle
    ms credited to the innermost span, each a step."""
    k = summary["steps"]
    rows = [f"{'span':<14}{'count/step':>11}{'host ms/step':>13}"
            f"{'launches/step':>14}{'syncs/step':>11}{'idle ms/step':>13}"]
    items = sorted(summary["by_span"].items(), key=lambda kv: -kv[1][
        "host_us"])
    for name, s in items + [(OUTSIDE, {"count": 0, "host_us": 0.0,
                                       "self": summary["outside"]})]:
        c = s["self"]
        rows.append(f"{name:<14}{s['count'] / k:>11.2f}"
                    f"{s['host_us'] * 1e-3 / k:>13.3f}"
                    f"{c['launches'] / k:>14.1f}{c['syncs'] / k:>11.2f}"
                    f"{c['idle_us'] * 1e-3 / k:>13.3f}")
    return "\n".join(rows)
