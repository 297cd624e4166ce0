"""Diagnose the port on one NVIDIA GPU, beyond chip_smoke's checks.

Run from the root of a checkout:  ``python3 -m scflow_torch.tools.chip_diag``

It uses chip_smoke's configuration (batch 32, 256², 21 classes, 8
iterations, lowres, f32) and helpers. Phases (one JSON line each):
  k1_floor  K1's device time on the main path's render, beside the floor
            under it: the kernel on the same objects moved off the frame
            (binning and background stores only) and torch filling the
            same three outputs.
  steps     the eval step, with the card's SM clock, power and throttle
            reasons sampled by ``nvidia-smi -lms`` beside every step:
            ``plain`` steps are timed on the host only; ``profiled`` steps
            run under torch.profiler, which adds each step's device busy
            time (the union of its kernels' intervals), busy share and
            kernel count, and the kernels whose calls or time differ most
            between the busiest and the least busy profiled step.
"""
from __future__ import annotations

import collections
import datetime
import json
import os
import statistics
import subprocess
import sys
import time

PLAIN_STEPS, PROFILED_STEPS = 20, 8
SAMPLE_MS = 50
SMI_FIELDS = ("timestamp,clocks.sm,power.draw,"
              "clocks_throttle_reasons.active")


def phase_k1_floor(cs, renderer, batch) -> None:
    import torch

    from scflow_torch.ops import rasterize_fast as rf

    args = cs.tile_pass_args(renderer, batch, batch["ref_translations"])
    empty = cs.tile_pass_args(renderer, batch, batch["ref_translations"]
                              + torch.tensor([3000.0, 0.0, 0.0], device="cuda"))
    cs.check(bool((rf.rasterize_tiles(*empty)[0] == -1).all()),
             "k1_floor: the moved objects are not off the frame")
    out = rf.rasterize_tiles(*args)

    def fill():
        out[0].fill_(-1)
        out[1].zero_()
        out[2].zero_()

    cs.emit(phase="k1_floor",
            ms=cs.device_ms(lambda: rf.rasterize_tiles(*args), cs.KERNEL_REPS),
            empty_frame_ms=cs.device_ms(lambda: rf.rasterize_tiles(*empty),
                                        cs.KERNEL_REPS),
            fill_outputs_ms=cs.device_ms(fill, cs.KERNEL_REPS),
            output_bytes=sum(x.numel() * x.element_size() for x in out))


class ClockLog:
    """``nvidia-smi`` sampling the card every SAMPLE_MS into a file under
    the gitignored build directory, from ``start`` until ``stop``."""

    def __init__(self, path: str):
        self.path = path
        self.proc = None

    def start(self) -> None:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with open(self.path, "w") as f:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
                 "--format=csv,noheader,nounits", "-lms", str(SAMPLE_MS)],
                stdout=f, stderr=subprocess.DEVNULL)
        time.sleep(1.0)                  # let the first samples arrive

    def stop(self) -> list[tuple[float, float, float, str]]:
        """The samples as (unix time, SM MHz, watts, throttle reasons)."""
        time.sleep(2 * SAMPLE_MS / 1e3)
        self.proc.terminate()
        self.proc.wait(timeout=30)
        samples = []
        with open(self.path) as f:
            for line in f:
                parts = [p.strip() for p in line.split(",")]
                try:
                    t = datetime.datetime.strptime(
                        parts[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
                    samples.append((t, float(parts[1]), float(parts[2]),
                                    parts[3]))
                except (ValueError, IndexError):
                    continue
        return samples


def in_window(samples, t0: float, t1: float) -> dict:
    inside = [s for s in samples if t0 <= s[0] <= t1]
    if not inside:
        return {"clock_samples": 0}
    return {"clock_samples": len(inside),
            "sm_mhz": [s[1] for s in inside],
            "power_w_median": statistics.median(s[2] for s in inside),
            "throttle": sorted({s[3] for s in inside})}


def phase_steps(step, batch) -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function

    from ..utils.profiling import checked_trace

    log = ClockLog(os.path.join("scflow_torch", "_build", "clocks.csv"))
    log.start()
    try:
        plain = []
        for _ in range(PLAIN_STEPS):
            t0 = time.time()
            step(batch)
            torch.cuda.synchronize()
            plain.append((t0, time.time()))
        profiled = []

        def run():
            profiled.clear()
            for _ in range(PROFILED_STEPS):
                t0 = time.time()
                with record_function("chip_diag_step"):
                    step(batch)
                    torch.cuda.synchronize()
                profiled.append((t0, time.time()))

        # a trace that holds every K1 and K2 kernel launched in it
        prof, lost = checked_trace(run, [ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
    finally:
        samples = log.stop()
    if prof is None:
        raise AssertionError(f"chip_diag: every trace lost kernels {lost}")

    events = prof.events()
    # every kernel of a step ends before the step's synchronize returns, so
    # it lies inside the step's host range, on the profiler's clock
    # (the step's range also appears on the device as an annotation)
    windows = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.name == "chip_diag_step"
                     and e.device_type == DeviceType.CPU)
    kernels = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in events
                     if e.device_type == DeviceType.CUDA and e.name not in (
                         "chip_diag_step", "Buffer Flush",
                         "Activity Buffer Request"))
    if len(windows) != len(profiled):
        raise AssertionError(f"chip_diag: {len(windows)} step ranges for "
                             f"{len(profiled)} steps")
    rows, by_name = [], []
    for (w0, w1), (t0, t1) in zip(windows, profiled):
        busy, end = 0.0, -float("inf")
        names = collections.defaultdict(lambda: [0, 0.0])  # calls, ms
        for s0, s1, name in kernels:
            if w0 <= s0 <= w1:
                busy += max(0.0, s1 - max(s0, end))
                end = max(end, s1)
                names[name][0] += 1
                names[name][1] += (s1 - s0) / 1e3
        wall_ms = (w1 - w0) / 1e3
        rows.append(dict(wall_ms=wall_ms, busy_ms=busy / 1e3,
                         busy_share=busy / 1e3 / wall_ms,
                         kernels=sum(c for c, _ in names.values()),
                         **in_window(samples, t0, t1)))
        by_name.append(names)
    # the kernels whose calls or time differ most between the profiled
    # steps of most and least device busy time
    slow = max(range(len(rows)), key=lambda i: rows[i]["busy_ms"])
    fast = min(range(len(rows)), key=lambda i: rows[i]["busy_ms"])
    diff = []
    for name in by_name[slow].keys() | by_name[fast].keys():
        (c1, m1), (c0, m0) = by_name[slow][name], by_name[fast][name]
        if c1 != c0 or abs(m1 - m0) > 0.5:
            diff.append(dict(name=name[:90], calls=[c1, c0], ms=[m1, m0]))
    diff.sort(key=lambda d: -abs(d["ms"][0] - d["ms"][1]))
    plain_rows = [dict(wall_ms=1e3 * (t1 - t0), **in_window(samples, t0, t1))
                  for t0, t1 in plain]
    print(json.dumps(dict(phase="steps", sample_ms=SAMPLE_MS,
                          samples=len(samples), plain=plain_rows,
                          profiled=rows, busiest=slow, least_busy=fast,
                          kernels_differing=diff[:12])), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_diag: no CUDA GPU available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from scflow_torch.rendering import Renderer, make_test_meshes
    from scflow_torch.training import (Config, ModelConfig, build_model,
                                       make_eval_step)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.emit(phase="env", gpu=torch.cuda.get_device_name(0),
            nvidia_smi=subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60, check=True).stdout.strip(),
            torch=torch.__version__, cuda=torch.version.cuda)
    renderer = Renderer(make_test_meshes(cs.NUM_CLASS, subdivisions=3,
                                         radius=60.0, device="cuda"),
                        image_size=cs.SIZE)
    with torch.inference_mode():
        batch = cs.make_batch(renderer, cs.BATCH, seed=0)
        phase_k1_floor(cs, renderer, batch)
    cfg = Config(model=ModelConfig(num_class=cs.NUM_CLASS, iters=cs.ITERS,
                                   test_iters=cs.ITERS))
    step = make_eval_step(build_model(cfg, device="cuda", seed=0), renderer,
                          cfg, device="cuda")
    for _ in range(cs.WARMUP):
        step(batch)
    torch.cuda.synchronize()
    phase_steps(step, batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
