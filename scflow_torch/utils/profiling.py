"""Profiling helpers (port of ``scflow_tpu/utils/profiling.py``):
torch.profiler traces and per-phase wall timing.

``PhaseTimer`` times phases of the hot path (render / encode / GRU loop /
loss) on the host clock, synchronising the GPU at each phase's end so the
phase's queued kernels are counted; ``trace`` records a torch.profiler
trace and writes it as a Chrome trace (chrome://tracing, Perfetto,
TensorBoard's profile plugin).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA when a GPU is present) and write
    ``log_dir/trace_<pid>_<ns>.json``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class PhaseTimer:
    """Accumulating per-phase wall timer with device synchronisation.

    Usage::
        timer = PhaseTimer()
        with timer("render"):
            out = renderer(...)   # the GPU is synchronised on exit
        print(timer.summary())

    The JAX timer blocks on a registered output; CUDA has no per-tensor
    wait, so this one synchronises the whole device when CUDA has been
    initialised (on the CPU there is nothing to wait for).
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.totals[phase] += time.perf_counter() - t0
            self.counts[phase] += 1

    def summary(self) -> dict[str, float]:
        """Mean milliseconds per phase."""
        return {k: 1000.0 * self.totals[k] / max(self.counts[k], 1)
                for k in self.totals}

    def report(self) -> str:
        return " | ".join(f"{k}: {v:.2f}ms" for k, v in self.summary().items())
