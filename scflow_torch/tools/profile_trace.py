"""Trace a hot-path step under torch.profiler and attribute its device time
(port of ``tools/profile_trace.py``).

The JAX tool reads the xplane of a ``jax.profiler`` trace and sums the
XLA ops' time on the TPU by ``hlo_category``, by the first ``scflow_tpu``
frame of each op's ``source_stack`` and by op. This tool traces ``--steps``
steps (after one un-traced call) and attributes each CUDA kernel's time
three ways:

- by category (``CATEGORIES``: K1, K2, copy / layout transform,
  convolution, GEMM, index / gather / scatter, reduction, elementwise,
  other), the counterpart of ``hlo_category``;
- by source line: the innermost ``scflow_torch/`` frame that dispatched
  the op which launched the kernel, as ``file(line): function``. A
  dispatch mode (``SourceRanges``) runs each op inside a
  ``record_function`` range named by that frame, and the profiler links
  each kernel to its op (torch.profiler's own ``with_stack`` stacks are
  empty on some builds). K1's and K2's kernels, launched through ctypes
  by their wrappers alone, take their wrapper's source by name; a
  backward kernel takes its forward op's source (the autograd node's
  sequence number); a kernel with neither goes under ``?``;
- by op: kernel name | source.

The trace must hold every K1 and K2 kernel the wrappers launched in it,
as often as they launched it (``utils.profiling.checked_trace``): it is
taken again up to 3 times, then the tool raises. PyTorch runs no
container ops (XLA's while / conditional, which the JAX tool reports
apart), so every kernel is counted once. The ranges cost host time: the
wall ms per step under the profiler is not the step's. With ``--device
cpu`` the same sums run over the CPU ops' self time.

  python -m scflow_torch.tools.profile_trace [--batch 32] [--top 30]
      [--steps 3] [--mode eval|train] [--device cpu]
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..device import resolve_device, synchronize

# (category, pattern) in order: the first that matches a kernel's (or a
# CPU op's) name takes it
CATEGORIES = (
    ("K1", r"bin_chunks_kernel|rasterize_tiles_kernel"),
    ("K2", r"instance_norm_"),
    # before convolution: cuDNN's own layout transforms
    ("copy", r"[Cc]opy|Memcpy|Memset|nchwToNhwc|nhwcToNchw|transpose|"
             r"CatArray|aten::(cat|clone|contiguous|stack|to|_to_copy)$"),
    ("convolution", r"conv|cudnn|fprop|dgrad|wgrad|winograd"),
    ("gemm", r"gemm|nvjet|cublas|aten::(mm|bmm|addmm|baddbmm|matmul|"
             r"linear)$"),
    ("index", r"index|gather|scatter|take|embedding|grid_sampler|"
              r"searchsorted|put_|aten::(where|masked_fill_?)$"),
    ("reduction", r"reduce|Reduce|softmax|cumsum|scan|sort|topk|welford|"
                  r"batch_norm_collect|aten::(sum|mean|amax|amin|max|min|"
                  r"var|std|norm|all|any|argmax|argmin|prod|logsumexp)$"),
    ("elementwise", r"elementwise|vectorized|unrolled|fill|pointwise|"
                    r"aten::"),
)
_CATEGORY_RE = [(name, re.compile(p)) for name, p in CATEGORIES]


def category(name: str) -> str:
    for cat, pattern in _CATEGORY_RE:
        if pattern.search(name):
            return cat
    return "other"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--mode", default="eval", choices=("eval", "train"))
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build_step(batch: int, mode: str, dtype: str = "bfloat16",
               iters: int = 8, device: str = "cuda") -> tuple:
    """(a step of no arguments, its ``Config``) at the JAX tool's
    configuration: 21 classes, ``make_test_meshes(21, subdivisions=3,
    radius=60)``, 256², seeded weights, one synthetic batch; the eval
    step, or the train step on the batch supervised at the reference pose
    (translations × 1.01, the rendered masks)."""
    from ..data import synthetic_batch
    from ..rendering import Renderer, make_test_meshes
    from ..training import (Config, ModelConfig, build_model,
                            build_points_bank, make_eval_step,
                            make_optimizer, make_train_step, render_at_pose)

    bank = make_test_meshes(num_classes=21, subdivisions=3, radius=60.0,
                            device=device)
    renderer = Renderer(bank, image_size=(256, 256))
    cfg = Config(model=ModelConfig(num_class=21, iters=iters,
                                   test_iters=iters, dtype=dtype))
    model = build_model(cfg, device=device)
    batch_data = synthetic_batch(torch.Generator().manual_seed(0), renderer,
                                 batch)
    if mode == "eval":
        step = make_eval_step(model, renderer, cfg, device=device)
        return (lambda: step(batch_data)), cfg

    with torch.no_grad():
        _, _, mask = render_at_pose(
            renderer, batch_data["ref_rotations"],
            batch_data["ref_translations"], batch_data["k"],
            batch_data["labels"].long(), cfg.data.normalize_mean,
            cfg.data.normalize_std)
    train_batch = dict(
        batch_data, gt_rotations=batch_data["ref_rotations"],
        gt_translations=batch_data["ref_translations"] * 1.01, gt_masks=mask)
    step = make_train_step(model, renderer,
                           build_points_bank(bank, num_points=1000), cfg,
                           make_optimizer(cfg, model.parameters()),
                           device=device)
    return (lambda: step(train_batch)), cfg


_BACKWARD = "autograd::engine::evaluate_function"
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_OWN = {os.path.abspath(__file__), os.path.join(_PACKAGE, "utils",
                                                "profiling.py")}


def caller_source() -> str | None:
    """The innermost frame of the running thread in ``scflow_torch/`` (this
    tool and the profiling helpers aside) as ``file(line): function``,
    the file relative to the package; None if there is none."""
    f = sys._getframe(1)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PACKAGE + os.sep) and path not in _OWN:
            return (f"{os.path.relpath(path, _PACKAGE)}({f.f_lineno}): "
                    f"{f.f_code.co_name}")
        f = f.f_back
    return None


class SourceRanges(TorchDispatchMode):
    """Runs each dispatched op inside a ``record_function`` range named
    ``SOURCE_PREFIX`` + the op's ``caller_source``, so that a trace links
    the op and its kernels to the line that called it (torch.profiler's
    own Python stacks are missing on some builds). Ops of a backward pass
    get none: their forward op's source is theirs."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from ..utils.profiling import SOURCE_PREFIX

        src = caller_source()
        if src is None or torch._C._current_autograd_node() is not None:
            return func(*args, **(kwargs or {}))
        with torch.profiler.record_function(SOURCE_PREFIX + src):
            return func(*args, **(kwargs or {}))


def wrapper_sources() -> dict:
    """``k1``, ``k2_fwd`` and ``k2_bwd`` → the source of the wrapper that
    alone launches those kernels (through ctypes, dispatching no op)."""
    from ..ops import fused_norm, rasterize_fast

    out = {}
    for kernel, fn in (("k1", rasterize_fast.rasterize_tiles),
                       ("k2_fwd", fused_norm.instance_norm_fwd),
                       ("k2_bwd", fused_norm.instance_norm_bwd)):
        code = fn.__code__
        out[kernel] = (f"{os.path.relpath(code.co_filename, _PACKAGE)}"
                       f"({code.co_firstlineno}): {code.co_name}")
    return out


def source(event, forward: dict | None = None) -> str:
    """The source of ``event``: that of the range its own dispatch opened
    (a child, or a grandchild's, of its event), else of the innermost
    ``SourceRanges`` range around it; under a backward node, that of its
    forward op (``forward``: sequence number → source); else ``?``."""
    from ..utils.profiling import SOURCE_PREFIX

    # an op's dispatch opens its range inside the op's own event (and an
    # autograd function's, inside its first op's): look a few levels down
    level = [event]
    for _ in range(3):
        level = [c for e in level for c in e.cpu_children]
        for c in level:
            if c.name.startswith(SOURCE_PREFIX):
                return c.name[len(SOURCE_PREFIX):]
    e = event
    while e is not None:
        if e.name.startswith(SOURCE_PREFIX):
            return e.name[len(SOURCE_PREFIX):]
        if forward and e.name.startswith(_BACKWARD):
            src = forward.get(e.sequence_nr)
            if src:
                return src
        e = e.cpu_parent
    return "?"


# the profiler's events of the Python dispatch itself (no op's work)
_DISPATCH_EVENTS = ("PythonDispatchMode", "PythonTLSSnapshot")


def _is_op(e) -> bool:
    from torch.autograd import DeviceType

    return (e.device_type == DeviceType.CPU and not e.is_user_annotation
            and not getattr(e, "is_python_function", False)
            and e.name not in _DISPATCH_EVENTS)


def forward_sources(events) -> dict:
    """Each forward op's sequence number → its source (the source range
    that its dispatch opened, inside it), for the backward nodes that
    carry the same number."""
    from ..utils.profiling import SOURCE_PREFIX

    out = {}
    for e in events:
        if not e.name.startswith(SOURCE_PREFIX):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(SOURCE_PREFIX):
            if p.sequence_nr >= 0 and _is_op(p):
                out.setdefault(p.sequence_nr, e.name[len(SOURCE_PREFIX):])
            p = p.cpu_parent
    return out


def records(prof, device: str) -> tuple:
    """(the (name, µs, source) of every CUDA kernel in the trace, or on the
    CPU of every op's self time; the trace's total µs of kernels or ops).
    K1's and K2's kernels take their wrapper's source. Any other kernel
    takes the source of the outermost event the profiler lists it under
    (the op that launched it; the profiler's own bookkeeping events
    inside the op list it again); the time of a kernel name that the
    links do not cover goes under ``?``."""
    from torch.autograd import DeviceType

    from ..utils.profiling import NOT_KERNELS

    events = prof.events()
    forward = forward_sources(events)
    if device != "cuda":
        recs = [(e.name, e.self_cpu_time_total, source(e, forward))
                for e in events if _is_op(e)]
        return recs, sum(us for _, us, _ in recs)
    on_device = collections.Counter()
    for e in events:
        if (e.device_type == DeviceType.CUDA and not e.is_user_annotation
                and e.name not in NOT_KERNELS):
            on_device[e.name] += e.time_range.elapsed_us()
    wrappers = wrapper_sources()
    out = [(name, us, wrappers[kind]) for name, us in on_device.items()
           if (kind := _wrapper_kernel(name))]
    linked = collections.Counter({name: us for name, us, _ in out})
    by_name = set(linked)
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        above, p = set(), e.cpu_parent
        while p is not None:
            above.update(k.name for k in p.kernels)
            p = p.cpu_parent
        src = source(e, forward)
        for k in e.kernels:
            if (k.name in on_device and k.name not in above
                    and k.name not in by_name):
                out.append((k.name, k.duration, src))
                linked[k.name] += k.duration
    out += [(name, us - linked[name], "?")
            for name, us in on_device.items() if us - linked[name] > 0]
    return out, sum(on_device.values())


def _wrapper_kernel(kernel: str) -> str | None:
    """``k1``, ``k2_fwd`` or ``k2_bwd`` for a kernel of K1 or K2 by name,
    else None."""
    from ..utils.profiling import K1_KERNELS

    if any(k in kernel for k in K1_KERNELS):
        return "k1"
    if "instance_norm_" in kernel:
        return "k2_bwd" if "bwd" in kernel else "k2_fwd"
    return None


def aggregate(recs: list) -> tuple:
    """(by category, by source, by op, total) in µs."""
    by_cat, by_src, by_op = (collections.Counter() for _ in range(3))
    for name, us, src in recs:
        by_cat[category(name)] += us
        by_src[src] += us
        by_op[f"{name} | {src[:60]}"] += us
    return by_cat, by_src, by_op, sum(us for _, us, _ in recs)


def trace_steps(fn, steps: int, device: str):
    """(the profile, wall seconds) of ``steps`` calls of ``fn`` traced
    under ``SourceRanges``; on the card a checked trace, or it raises."""
    from torch.profiler import ProfilerActivity, profile

    from ..utils.profiling import checked_trace

    wall = []

    def run():
        t0 = time.perf_counter()
        with SourceRanges():
            for _ in range(steps):
                fn()
        synchronize(device)
        wall.append(time.perf_counter() - t0)

    if device != "cuda":
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run()
        return prof, wall[-1]
    prof, lost = checked_trace(run, [ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA])
    if prof is None:
        raise RuntimeError(f"profile_trace: every trace lost kernels (the "
                           f"last kept {lost['kept']} of {lost['launched']} "
                           f"K1/K2 kernels launched)")
    return prof, wall[-1]


def summarize(prof, device: str, steps: int, top: int) -> dict:
    """The trace's attributions in ms per step: ``by_category``, the top
    ``top`` sources and ops, each attribution's sum, the trace's own
    total (``traced_ms_per_step``) and the share under ``?``."""
    recs, traced = records(prof, device)
    by_cat, by_src, by_op, total = aggregate(recs)
    per = 1e-3 / steps                      # µs over the steps → ms a step
    return {
        "device": device, "steps": steps,
        "traced_ms_per_step": traced * per, "total_ms_per_step": total * per,
        "events_per_step": len(recs) / steps,
        "by_category": {k: v * per for k, v in by_cat.most_common()},
        "by_source_top": {k: v * per for k, v in by_src.most_common(top)},
        "by_source_sum_ms": sum(by_src.values()) * per,
        "sources": sorted(by_src),
        "by_op_top": {k: v * per for k, v in by_op.most_common(top)},
        "by_op_sum_ms": sum(by_op.values()) * per,
        "unattributed_share": by_src["?"] / total if total else 0.0,
    }


def main(argv=None) -> dict:
    """Trace, print the JAX tool's sections and a JSON summary; return the
    summary (ms per step)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    fn, _ = build_step(args.batch, args.mode, device=str(dev))
    fn()                                    # the un-traced call
    synchronize(dev)
    prof, wall = trace_steps(fn, args.steps, dev.type)
    summary = dict(summarize(prof, dev.type, args.steps, args.top),
                   mode=args.mode, batch=args.batch,
                   wall_ms_per_step=wall * 1e3 / args.steps)
    total = summary["total_ms_per_step"]
    what = "kernel" if dev.type == "cuda" else "op self"
    print(f"steps: {args.steps} traced, {summary['wall_ms_per_step']:.3f} "
          f"ms/step wall (under the profiler)")
    print(f"{what} time: {total:.3f} ms/step, "
          f"{summary['events_per_step']:.0f} {what} events/step\n")
    sections = (
        ("by category:", summary["by_category"]),
        ("\ncontainer ops: none (PyTorch runs no while/conditional ops; "
         "each kernel is counted once)", {}),
        (f"\nby source line (top {args.top}; ? "
         f"{100 * summary['unattributed_share']:.1f}%):",
         summary["by_source_top"]),
        (f"\nby op (top {args.top}):", summary["by_op_top"]))
    for title, ms in sections:
        print(title)
        for k, v in ms.items():
            print(f"  {v:9.3f}  {100 * v / total:5.1f}%  {k[:110]}")
    print(json.dumps({k: v for k, v in summary.items() if k != "sources"}),
          flush=True)
    return summary


if __name__ == "__main__":
    main()
