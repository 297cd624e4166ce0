"""Profiling helpers (port of ``scflow_tpu/utils/profiling.py``):
named spans on the hot path, torch.profiler traces, the card's peaks,
checked traces of the hand-written kernels and the work a block of ops
does.

``span(name)`` marks a part of the step (see README's list of spans).
Spans are off by default: ``span`` then returns one shared no-op context,
which dispatches no op, allocates nothing and records nothing, so the
step runs exactly as unmarked. ``enable_spans(flag)`` or the block form
``spans_enabled()`` turns them on; each span is then a
``torch.profiler.record_function`` range named ``SPAN_PREFIX + name``, on
the profiler's own clock, beside the kernels it launches. ``trace``
records a torch.profiler trace with spans on and writes it as a Chrome
trace (chrome://tracing, Perfetto, TensorBoard's profile plugin).

``checked_trace`` takes a trace again until it holds every K1 and K2
kernel the wrappers launched in it (traces have been seen to lose
kernels late in a long process). ``count_work`` counts the flops
(``torch.utils.flop_counter.FlopCounterMode``) and the bytes (each
dispatched op's operands and outputs) of a block; the hand-written
kernels declare their own work through ``kernel_work``, so a count is
the same whether their CUDA launches or their plain versions ran.
"""
from __future__ import annotations

import collections
import contextlib
import os
import re
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# H100 SXM peaks (NVIDIA data sheet, dense): FP32 CUDA cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# each card's dense peaks by ``torch.cuda.get_device_name()``: flop/s by
# compute type (TF32: f32 matmuls and convolutions on the tensor cores,
# where the process allows it) and HBM bytes/s
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "tf32": 495e12,
                              "float32": PEAK_FP32, "bytes": PEAK_BYTES},
}


def device_peaks(name: str) -> dict:
    """``PEAKS[name]``; an unknown card raises, naming it."""
    if name not in PEAKS:
        raise ValueError(f"no peak figures for the card {name!r}: add its "
                         f"data sheet's dense peaks to PEAKS")
    return PEAKS[name]


def tf32_on() -> bool:
    """Whether f32 matmuls or convolutions may run in TF32 now."""
    return (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32)


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 for matmuls and cuDNN on (or off) inside the block; both flags
    are restored on exit."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


# the prefix of a span's range (distinct from the ranges the benchmark
# and ``tools/profile_trace.py`` open)
SPAN_PREFIX = "scflow.span:"


class _NoSpan:
    """The context ``span`` returns while spans are off: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_spans_on = False


def span(name: str):
    """A context marking part of the step: while spans are off, the one
    shared no-op context; while on, a ``record_function`` range named
    ``SPAN_PREFIX + name``."""
    if not _spans_on:
        return _NO_SPAN
    return torch.profiler.record_function(SPAN_PREFIX + name)


def enable_spans(flag: bool) -> bool:
    """Turn the process's spans on or off; returns whether they were on."""
    global _spans_on
    was, _spans_on = _spans_on, bool(flag)
    return was


@contextlib.contextmanager
def spans_enabled(flag: bool = True):
    """Spans on (or off) inside the block, as they were after it."""
    was = enable_spans(flag)
    try:
        yield
    finally:
        enable_spans(was)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA when a GPU is present) with spans
    on and write ``log_dir/trace_<pid>_<ns>.json``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof, spans_enabled():
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


# the profiler's own bookkeeping events on the device (not kernels)
NOT_KERNELS = ("Buffer Flush", "Activity Buffer Request")
# the prefix of the ranges ``tools/profile_trace.py`` opens around each op,
# named by the op's source line (device events too; not kernels)
SOURCE_PREFIX = "scflow.src:"


# the kernels a K1 call launches: the binning, then the raster pass
K1_KERNELS = ("bin_chunks_kernel", "rasterize_tiles_kernel")
# K2's kernels by name (template arguments dropped), with the direction
# and form whose launch runs each once; a backward launch of every form
# but the general one (which sums dscale and dbias in its own kernel)
# also runs instance_norm_bwd_reduce once
K2_KERNELS = {"instance_norm_fwd_kernel": ("fwd", "vector"),
              "instance_norm_fwd_warp": ("fwd", "warp"),
              "instance_norm_fwd_any": ("fwd", "general"),
              "instance_norm_fwd_cluster": ("fwd", "cluster"),
              "instance_norm_split_stats": ("fwd", "split"),
              "instance_norm_split_fwd": ("fwd", "split"),
              "instance_norm_bwd_kernel": ("bwd", "vector"),
              "instance_norm_bwd_warp": ("bwd", "warp"),
              "instance_norm_bwd_any": ("bwd", "general"),
              "instance_norm_bwd_cluster": ("bwd", "cluster"),
              "instance_norm_split_bwd_stats": ("bwd", "split"),
              "instance_norm_split_bwd": ("bwd", "split"),
              "instance_norm_bwd_reduce": ("bwd", None)}
K2_BWD_REDUCE_FORMS = ("vector", "warp", "cluster", "split")
PROFILE_TRIES = 3
_KERNEL_NAME = re.compile("|".join((*K1_KERNELS, r"instance_norm_\w+")))


def launch_snapshot() -> tuple:
    """The wrappers' launch counts now: K1's calls, and K2's forward and
    backward launches by (form, dtype)."""
    from ..ops import rasterize_fast as rf
    from ..ops.fused_norm import instance_norm_bwd, instance_norm_fwd

    return (rf.rasterize_tiles.launches,
            {d: collections.Counter(w.form_launches) for d, w in
             (("fwd", instance_norm_fwd), ("bwd", instance_norm_bwd))})


def launched_kernels(before: tuple) -> collections.Counter:
    """The K1 and K2 kernels by name that the wrappers launched since the
    ``launch_snapshot`` ``before``: 2 a K1 call, K2's by its forms'
    launches (``K2_KERNELS``; a backward launch of a form of
    ``K2_BWD_REDUCE_FORMS`` adds one reduce)."""
    k1, k2 = launch_snapshot()
    forms = collections.Counter()
    for d, counter in k2.items():
        for (form, _), n in (counter - before[1][d]).items():
            forms[d, form] += n
            if d == "bwd" and form in K2_BWD_REDUCE_FORMS:
                forms[d, None] += n
    want = collections.Counter({k: forms[v] for k, v in K2_KERNELS.items()})
    for name in K1_KERNELS:
        want[name] = k1 - before[0]
    return +want


def traced_kernels(prof) -> collections.Counter:
    """The K1 and K2 kernels in a torch.profiler trace by name (template
    arguments and namespaces dropped) and their count (from the trace's
    events: ``key_averages`` would add seconds of sums to a long trace)."""
    seen = collections.Counter()
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.name.startswith(SOURCE_PREFIX)):
            continue
        name = _KERNEL_NAME.search(e.name)
        if name:
            seen[name.group()] += 1
    return seen


def checked_trace(fn, activities=None, **profile_kwargs):
    """``fn`` under torch.profiler (``profile_kwargs`` go to ``profile``),
    taken again (up to ``PROFILE_TRIES`` times) until the trace holds every
    K1 and K2 kernel the wrappers launched in it, as often as they launched
    it: late in a long process traces have lost kernels. Returns (the
    profile, None), or (None, what the last trace kept against what was
    launched)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        before = launch_snapshot()
        with profile(activities=activities or [ProfilerActivity.CUDA],
                     **profile_kwargs) as prof:
            fn()
            torch.cuda.synchronize()
        seen, want = traced_kernels(prof), launched_kernels(before)
        if seen == want:
            return prof, None
    return None, dict(kept=sum(seen.values()), launched=sum(want.values()))


# allocations write nothing
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided"}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _ByteMode(TorchDispatchMode):
    """Sums each dispatched op's tensor operand and output bytes (views
    and allocations move none) while not paused."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (not self.paused and not func.is_view
                and func.overloadpacket.__name__ not in _NO_BYTES):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


class WorkCount:
    """What ``count_work`` counted: ``flops`` (FlopCounterMode's, less what
    it saw inside declared kernels, plus their declared operations) and
    ``bytes``; ``kernels`` counts each declared kernel's calls."""

    def __init__(self, flop_mode):
        self._flop_mode = flop_mode
        self._bytes = _ByteMode()
        self._excluded = 0
        self.declared_flops = 0
        self.declared_bytes = 0
        self.kernels = collections.Counter()

    @property
    def flops(self) -> int:
        return (self._flop_mode.get_total_flops() - self._excluded
                + self.declared_flops)

    @property
    def bytes(self) -> int:
        return self._bytes.bytes + self.declared_bytes


_COUNTS: list = []


@contextlib.contextmanager
def count_work():
    """Count the flops and bytes of the ops run in the block; yields a
    ``WorkCount``. The dispatched ops are counted as they run (eager,
    unfused: each op's operands are read and its outputs written once);
    a hand-written kernel counts its declared work (``kernel_work``)."""
    from torch.utils.flop_counter import FlopCounterMode

    flop_mode = FlopCounterMode(display=False)
    work = WorkCount(flop_mode)
    _COUNTS.append(work)
    try:
        with flop_mode, work._bytes:
            yield work
    finally:
        _COUNTS.remove(work)


@contextlib.contextmanager
def kernel_work(name: str, work_fn):
    """Around a hand-written kernel's wrapper or its plain version: under
    ``count_work`` the block's own ops are not counted, and ``work_fn()``
    → (operations, bytes), the kernel's work whatever runs it, is added
    once (the outermost such block counts). Elsewhere it does nothing."""
    work = _COUNTS[-1] if _COUNTS else None
    if work is None or work._bytes.paused:
        yield
        return
    before = work._flop_mode.get_total_flops()
    work._bytes.paused += 1
    try:
        yield
        ops, moved = work_fn()
    finally:
        work._bytes.paused -= 1
        work._excluded += work._flop_mode.get_total_flops() - before
    work.declared_flops += ops
    work.declared_bytes += moved
    work.kernels[name] += 1
