"""Per-phase roofline profile of the refinement hot path on the card (port
of ``tools/profile_roofline.py``).

For each of the JAX tool's phases (render, each encoder, the correlation
pyramid with its two encoders, the full forward, the eval step) this
times the phase alone, counts its flops and bytes, and prints a roofline
table: achieved TFLOP/s against the card's peak, achieved GB/s against
its HBM peak, and the flops per byte.

- **Time**: the host's clock over ``--steps`` calls after one warm-up
  call, ending in a device sync (the JAX tool's ``_time``). ``--steps 0``
  counts without timing (ms and rates null).
- **Flops**: ``torch.utils.flop_counter.FlopCounterMode`` over one call
  (matmuls and convolutions, every tap of a padded convolution counted).
- **Bytes**: XLA's "bytes accessed" sums each fused HLO op's operand and
  output bytes. The port runs eager, unfused ops, so its count sums each
  dispatched aten op's tensor operand and output bytes (views and
  allocations none): every intermediate goes through memory once written
  and once per reader, where XLA's fusions keep many in registers.
- **K1 and K2** (the tile rasterizer and the instance norm) run through
  ctypes on the card, where no dispatch mode sees them, and as plain ops
  on the CPU. Each declares its own work from its shapes instead (the
  figures behind the bounds of ``PERF.md``; ``utils.profiling.
  kernel_work``), so a phase counts the same on the card and the CPU.
- **Peaks** come from ``utils.profiling.PEAKS``, keyed by the card's name:
  the flops peak of ``--dtype`` (bf16 tensor cores; f32 CUDA cores, as
  the tool turns TF32 off for matmuls and cuDNN), HBM's bytes/s. An
  unknown card raises (the JAX tool fell back to a TPU v5e's peaks). On
  the CPU the shares are null.

  python -m scflow_torch.tools.profile_roofline [--batch 32] [--iters 8]
      [--dtype bfloat16] [--subdivisions 3] [--steps 20] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..device import resolve_device, synchronize

PHASES = ("render", "enc_render", "enc_real", "enc_context",
          "corr_build(+2enc)", "full_forward", "eval_step(e2e)")
NUM_CLASS, SIZE = 21, (256, 256)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--subdivisions", type=int, default=3)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _time(fn, steps: int, dev: torch.device) -> float:
    """Seconds per call over ``steps`` calls after one, to a device sync."""
    fn()
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    synchronize(dev)
    return (time.perf_counter() - t0) / steps


def build_phases(batch: int, iters: int, dtype: str, subdivisions: int,
                 device: str, num_class: int = NUM_CLASS,
                 size: tuple = SIZE, model=None) -> list:
    """The JAX tool's phases as (name, function of no arguments) at its
    configuration: 21 classes, ``make_test_meshes(21, subdivisions,
    radius=60)``, 256², seeded weights (or ``model``, built for
    ``size`` and ``num_class``), one synthetic batch."""
    from ..data import synthetic_batch
    from ..models.corr import correlation_pyramid
    from ..rendering import Renderer, make_test_meshes
    from ..training import (Config, ModelConfig, RenderConfig, build_model,
                            make_eval_step, normalization, render_at_pose)

    cfg = Config(model=ModelConfig(num_class=num_class, iters=iters,
                                   test_iters=iters, dtype=dtype),
                 render=RenderConfig(image_size=size))
    bank = make_test_meshes(num_class, subdivisions=subdivisions,
                            radius=60.0, device=device)
    renderer = Renderer(bank, image_size=size)
    model = build_model(cfg, device=device) if model is None else model
    b = synthetic_batch(torch.Generator().manual_seed(0), renderer, batch)
    norm = normalization(cfg, bank.device)
    args = (b["ref_rotations"], b["ref_translations"], b["k"],
            b["labels"].long())

    def render():
        return render_at_pose(renderer, *args, *norm)

    with torch.inference_mode():
        rendered, depth, _ = render()
    # the port's encoders take NCHW images (the JAX ones NHWC)
    rend_nchw = rendered.permute(0, 3, 1, 2).contiguous()
    real_nchw = b["real_images"].permute(0, 3, 1, 2).contiguous()

    def corr_build():
        return correlation_pyramid(model.render_encoder(rend_nchw),
                                   model.real_encoder(real_nchw),
                                   cfg.model.num_levels)

    eval_step = make_eval_step(model, renderer, cfg, device=device)
    fns = (render, lambda: model.render_encoder(rend_nchw),
           lambda: model.real_encoder(real_nchw),
           lambda: model.context(rend_nchw), corr_build,
           lambda: model(rendered, b["real_images"], b["ref_rotations"],
                         b["ref_translations"], depth, b["k"],
                         b["labels"].long()),
           lambda: eval_step(b))
    return list(zip(PHASES, fns))


def peak_figures(dev: torch.device, dtype: str) -> tuple:
    """(flop/s peak, bytes/s peak, what the flops peak is) of ``dev`` for
    ``dtype`` under the TF32 setting in force; (None, None, "cpu") on the
    CPU. An unknown card raises."""
    from ..utils.profiling import device_peaks, tf32_on

    if dev.type != "cuda":
        return None, None, "cpu"
    peaks = device_peaks(torch.cuda.get_device_name(dev))
    kind = ("bfloat16" if dtype == "bfloat16"
            else "tf32" if tf32_on() else "float32")
    return peaks[kind], peaks["bytes"], kind


def measure(name: str, fn, steps: int, dev: torch.device, peak_flops,
            peak_bytes) -> dict:
    """One phase's row: the JAX tool's columns, and the exact ``flops``
    and ``bytes`` counted."""
    from ..utils.profiling import count_work

    with torch.inference_mode():
        ms = _time(fn, steps, dev) * 1e3 if steps else None
        with count_work() as work:
            fn()
        synchronize(dev)
    fl, by = work.flops, work.bytes
    tf = fl / ms * 1e-9 if ms else None   # TFLOP/s = flops / (ms·1e-3) / 1e12
    gbs = by / ms * 1e-6 if ms else None
    return {
        "phase": name, "ms": ms, "gflops": fl * 1e-9, "gbytes": by * 1e-9,
        "tflops": tf,
        "pct_peak_flops": (100 * tf * 1e12 / peak_flops
                           if peak_flops and tf is not None else None),
        "gbps": gbs,
        "pct_peak_bw": (100 * gbs * 1e9 / peak_bytes
                        if peak_bytes and gbs is not None else None),
        "intensity": fl / max(by, 1.0), "flops": fl, "bytes": by,
    }


def _fmt(v) -> str:
    return "-" if v is None else f"{v:.3f}" if abs(v) < 10 else f"{v:.1f}"


def main(argv=None) -> list:
    """Print the roofline table and its JSON line; return the rows."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    # f32 on the CUDA cores, against their peak
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    peak_flops, peak_bytes, kind = peak_figures(dev, args.dtype)
    phases = build_phases(args.batch, args.iters, args.dtype,
                          args.subdivisions, str(dev))
    rows = [measure(name, fn, args.steps, dev, peak_flops, peak_bytes)
            for name, fn in phases]

    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(f"# device={torch.cuda.get_device_name(dev)} ({smi}) "
              f"peak={peak_flops / 1e12:g} TFLOP/s ({kind}), "
              f"{peak_bytes / 1e9:g} GB/s, dtype={args.dtype}, "
              f"batch={args.batch}")
    else:
        print(f"# device=cpu (no peaks), dtype={args.dtype}, "
              f"batch={args.batch}")
    hdr = ("phase", "ms", "gflops", "gbytes", "tflops", "%flops", "gbps",
           "%bw", "F/B")
    print(("{:<20}" + "{:>9}" * 8).format(*hdr))
    for r in rows:
        print(("{:<20}" + "{:>9}" * 8).format(
            r["phase"], *(_fmt(r[k]) for k in (
                "ms", "gflops", "gbytes", "tflops", "pct_peak_flops", "gbps",
                "pct_peak_bw", "intensity"))))
    print(json.dumps(rows), flush=True)
    return rows


if __name__ == "__main__":
    main()
