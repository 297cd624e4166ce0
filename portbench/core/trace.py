"""Traced steps after the window: where the device time goes.

Two traces of the same few steps (``trace_steps`` in the traffic file):

- a plain one (the device's activity alone, nothing added to the step):
  the device's busy time as the union of its kernels' intervals, the
  traced window's wall time on the host's clock, launches per step,
  kernel time by name, the longest idle gaps by the kernel the host was
  launching;
- one under ``LayerRanges``: every op the step dispatches runs in a
  ``record_function`` range named by its layer, found from the port's
  source files on the Python stack (``LAYERS``); the profiler links each
  kernel to its op, a backward op takes its forward op's layer (the
  autograd node's sequence number), and the hand-written kernels, which
  the port launches through ctypes and which so dispatch no op, take
  their layer by name. More than ``MAX_UNATTRIBUTED`` of kernel time
  under no layer fails the run.

A trace is taken again (up to ``TRIES`` times) until it holds every K1
and K2 kernel that the port's own counters say were launched in it: late
in a long process traces have been seen to lose kernels."""
from __future__ import annotations

import collections
import os
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PREFIX = "pb.layer:"
TRIES = 3
MAX_UNATTRIBUTED = 0.01
UNATTRIBUTED = "?"
# (layer, port files): the first rule with a file on the stack takes the op
LAYERS = (
    ("pnp", ("models/flow_pose.py", "geometry/pnp.py")),
    ("render", ("rendering/", "ops/rasterize_fast.py")),
    ("decoder", ("models/decoder.py", "models/corr.py", "models/gru.py",
                 "models/heads.py")),
    ("encoder", ("models/encoder.py", "models/refiner.py",
                 "models/layers.py", "ops/fused_norm.py")),
    ("loss", ("losses/", "geometry/flow.py")),
    ("step", ("training/",)),
)
# the port's hand-written kernels by name: K1's two launches a call, and
# K2's kernels with the direction and form whose launch runs each once (a
# backward launch of the forms in K2_BWD_REDUCE also runs the reduce)
K1_KERNELS = ("bin_chunks_kernel", "rasterize_tiles_kernel")
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
K2_BWD_REDUCE = ("vector", "warp", "cluster", "split")
NOT_KERNELS = ("Buffer Flush", "Activity Buffer Request")
_BACKWARD = "autograd::engine::evaluate_function"
_DISPATCH_EVENTS = ("PythonDispatchMode", "PythonTLSSnapshot")


def kernel_kind(name: str):
    """'k1', 'k2_fwd' or 'k2_bwd' for a hand-written kernel's name."""
    if any(k in name for k in K1_KERNELS):
        return "k1"
    if "instance_norm_" in name:
        return "k2_bwd" if "_bwd" in name else "k2_fwd"
    return None


def _short(name: str) -> str | None:
    for k in (*K1_KERNELS, *K2_KERNELS):
        if k in name:
            return k
    return None


def expected_kernels(before: tuple, after: tuple) -> collections.Counter:
    """The hand-written kernels by name that the port's counters
    (``program.launch_counts``) say ran between two readings."""
    want = collections.Counter()
    for name in K1_KERNELS:
        want[name] = after[0] - before[0]
    forms = collections.Counter()
    for d in ("fwd", "bwd"):
        for key, n in after[1][d].items():
            n -= before[1][d].get(key, 0)
            forms[d, key[0]] += n
            if d == "bwd" and key[0] in K2_BWD_REDUCE:
                forms[d, None] += n
    for name, key in K2_KERNELS.items():
        want[name] = forms[key]
    return +want


def traced_kernels(events) -> collections.Counter:
    seen = collections.Counter()
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            short = _short(e.name)
            if short and not e.is_user_annotation:
                seen[short] += 1
    return seen


class LayerRanges(TorchDispatchMode):
    """Runs each dispatched op in a range named ``PREFIX`` + its layer,
    from the port's files on the stack; ops of a backward pass get none
    (their forward op's layer is theirs)."""

    def __init__(self, port_root: str):
        super().__init__()
        self.root = port_root + os.sep

    def layer(self) -> str | None:
        files = set()
        f = sys._getframe(2)
        while f is not None:
            path = f.f_code.co_filename
            if path.startswith(self.root):
                files.add(path[len(self.root):].replace(os.sep, "/"))
            f = f.f_back
        for layer, prefixes in LAYERS:
            if any(p.startswith(prefixes) for p in files):
                return layer
        return None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        layer = self.layer()
        if layer is None or torch._C._current_autograd_node() is not None:
            return func(*args, **(kwargs or {}))
        with torch.profiler.record_function(PREFIX + layer):
            return func(*args, **(kwargs or {}))


def _is_op(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CPU
            and not e.is_user_annotation
            and not getattr(e, "is_python_function", False)
            and e.name not in _DISPATCH_EVENTS)


def _forward_layers(events) -> dict:
    out = {}
    for e in events:
        if not e.name.startswith(PREFIX):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(PREFIX):
            if p.sequence_nr >= 0 and _is_op(p):
                out.setdefault(p.sequence_nr, e.name[len(PREFIX):])
            p = p.cpu_parent
    return out


def _layer_of(event, forward: dict) -> str:
    level = [event]
    for _ in range(3):
        level = [c for e in level for c in e.cpu_children]
        for c in level:
            if c.name.startswith(PREFIX):
                return c.name[len(PREFIX):]
    e = event
    while e is not None:
        if e.name.startswith(PREFIX):
            return e.name[len(PREFIX):]
        if e.name.startswith(_BACKWARD):
            layer = forward.get(e.sequence_nr)
            if layer:
                return layer
        e = e.cpu_parent
    return UNATTRIBUTED


def layer_times(prof, events) -> dict:
    """Kernel µs by layer: the hand-written kernels by name, every other
    kernel by the op its launch is linked to (the profiler's raw events
    carry each kernel's link to the op that launched it); a kernel with no
    such op goes under ``UNATTRIBUTED``."""
    ops = {e.id: e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU
           and not e.is_async and e.id > 0}
    forward = _forward_layers(events)
    by_layer = collections.Counter()
    layers = {}
    for k in prof.profiler.kineto_results.events():
        name = k.name()
        if (k.device_type() != torch.autograd.DeviceType.CUDA
                or k.is_user_annotation() or name in NOT_KERNELS
                or name.startswith(PREFIX)):
            continue
        us = k.duration_ns() * 1e-3
        kind = kernel_kind(name)
        if kind:
            by_layer["render" if kind == "k1" else "encoder"] += us
            continue
        link = k.linked_correlation_id()
        if link not in layers:
            op = ops.get(link)
            layers[link] = (UNATTRIBUTED if op is None
                            else _layer_of(op, forward))
        by_layer[layers[link]] += us
    return dict(by_layer)


def _busy_and_gaps(kernels: list, t0: float, t1: float):
    """(busy µs as the union of kernel intervals within [t0, t1], the idle
    gaps [(start, end)] in that window)."""
    busy, gaps, at = 0.0, [], t0
    for s, e in sorted((max(s, t0), min(e, t1)) for s, e in kernels):
        if e <= at:
            continue
        if s > at:
            gaps.append((at, s))
            at = s
        busy += e - at
        at = e
    if at < t1:
        gaps.append((at, t1))
    return busy, gaps


def _profile(fn, steps: int, layer_mode=None):
    """(events, wall seconds, profiler) of ``steps`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if layer_mode is not None:
        activities.append(ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        if layer_mode is None:
            for _ in range(steps):
                fn()
        else:
            with layer_mode:
                for _ in range(steps):
                    fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof.events(), wall, prof


def _complete(events, before: tuple, after: tuple) -> bool:
    """Whether a trace holds the hand-written kernels the counters say
    ran between ``before`` and ``after``."""
    return traced_kernels(events) == expected_kernels(before, after)


def take(fn, steps: int, counts, layer_mode=None, reset=None):
    """(events, wall seconds, profiler) of ``steps`` calls of ``fn`` under
    the profiler, retaken until the trace holds the hand-written kernels
    the counters say ran. Plain: the device's activity alone, which costs
    the host least; with ``layer_mode`` (a ``LayerRanges``) the host's ops
    too, which the layers are read from. ``reset()`` runs before each try,
    so that what ``fn`` records describes the try that is kept."""
    for _ in range(TRIES):
        if reset is not None:
            reset()
        before = counts()
        events, wall, prof = _profile(fn, steps, layer_mode)
        if _complete(events, before, counts()):
            return events, wall, prof
    raise RuntimeError("every trace lost hand-written kernels that the "
                       "port's counters say were launched")


def summarize_plain(events, wall: float, steps: int) -> dict:
    """Busy and window seconds, launches, kernel seconds by name and kind,
    and the idle gaps of the plain trace."""
    kernels, by_name = [], collections.Counter()
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation and e.name not in NOT_KERNELS
                and not e.name.startswith(PREFIX)):
            kernels.append((e.time_range.start, e.time_range.end, e.name))
            by_name[e.name] += e.time_range.elapsed_us()
    kernels.sort()
    t0 = kernels[0][0]
    busy, gaps = _busy_and_gaps([k[:2] for k in kernels], t0,
                                max(k[1] for k in kernels))
    # the device waits for the host to launch the kernel after a gap
    starts = {k[0]: k[2] for k in kernels}
    gaps.sort(key=lambda g: g[0] - g[1])
    by_kind = collections.Counter()
    for name, us in by_name.items():
        by_kind[kernel_kind(name) or "other"] += us
    return {
        "steps": steps, "busy_s": busy * 1e-6, "window_s": wall,
        "launches": len(kernels),
        "kind_s": {k: v * 1e-6 for k, v in by_kind.items()},
        "device_ops": [[n, us * 1e-6] for n, us in by_name.most_common(10)],
        "idle_gaps": [["host launching " + starts.get(g[1], "?")[:120],
                       (g[1] - g[0]) * 1e-6] for g in gaps[:10]],
    }
