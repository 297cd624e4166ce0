#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SCFlow (``scflow_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases (each prints one JSON line; any failed check raises):
  env     card name and power limit, torch/CUDA versions; TF32 off.
  build   compile the hand-written kernels (``scflow_torch/ops/csrc``).
  k1      tile rasterizer kernel vs its plain PyTorch version on the main
          path's render (batch 32, 256², 21-class bench bank); times.
  k2      instance-norm kernel vs its plain version at the encoders' three
          shapes (batch 32), f32 and bf16; times, and F.instance_norm's,
          each call on an input copy that is not in L2.
  main    the eval step at batch 32, 21 classes, 256², 8 iterations,
          lowres, f32, seeded weights: launch counts, finite outputs, a
          moved pose, step time; the same 2 samples through the port on the
          CPU must agree; one full-res step and one 2-pass step.
  profile the main path's stages timed alone, and its kernels by device
          time under torch.profiler.
Then the ``kernels`` line, the card line from nvidia-smi and, last,
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA GPU.
"""
from __future__ import annotations

import itertools
import json
import math
import statistics
import subprocess
import sys
import time

BATCH = 32
SIZE = (256, 256)
NUM_CLASS = 21
ITERS = 8
WARMUP, STEPS = 2, 10
KERNEL_REPS = 20
# H100 SXM peaks (NVIDIA data sheet, dense): FP32 CUDA cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
L2_BYTES = 50 * 2 ** 20   # H100 L2 cache
K1_OPS_PER_PAIR = 22      # counted in csrc/rasterize.cu
K2_OPS_PER_ELEM = 8       # sum, centred square, normalise, affine
# tolerances of the CPU parity tests (tests/test_torch_port_*.py)
POSE_TOL = dict(rot_atol=2e-3, trans_rtol=2e-3, trans_atol=2e-4)


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def median_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median of ``reps`` single-call CUDA-event timings after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cold_inputs(x):
    """An endless cycle over copies of ``x`` that together span 4× the L2,
    so each timed call reads its input from HBM, the memory whose rate
    ``bound_ms`` holds it against."""
    copies = max(2, math.ceil(4 * L2_BYTES / (x.numel() * x.element_size())))
    return itertools.cycle([x] + [x.clone() for _ in range(copies - 1)])


def bf16_ulp(v):
    """Spacing of bf16 values (8 significand bits) at |v|."""
    return (v.float().abs().clamp_min(2.0 ** -126).log2().floor() - 7).exp2()


def bound_ms(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, ops / PEAK_FP32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def make_batch(renderer, n: int, seed: int):
    """Seeded scene: 'real' uint8 crops rendered at a random pose, and the
    initial pose that pose jittered (15° / (15, 15, 50) mm, clipped)."""
    import torch

    from scflow_torch.geometry import quaternion_to_matrix
    from scflow_torch.geometry.se3 import matmul3

    g = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, renderer.mesh_bank.num_classes, (n,), generator=g)
    gt_r = quaternion_to_matrix(torch.randn(n, 4, generator=g))
    gt_t = torch.cat([torch.rand(n, 2, generator=g) * 60 - 30,
                      torch.rand(n, 1, generator=g) * 400 + 500], dim=-1)
    h, w = renderer.image_size
    k = torch.tensor([[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1]]
                     ).expand(n, 3, 3).contiguous()
    axis = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1)
    angle = (torch.randn(n, generator=g) * math.radians(15)).clamp(
        -math.radians(45), math.radians(45))
    half = angle[:, None] / 2
    dq = torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)
    noise = torch.randn(n, 3, generator=g) * torch.tensor([15.0, 15.0, 50.0])
    noise = noise * (200.0 / noise.norm(dim=-1, keepdim=True)).clamp(max=1.0)
    ref_r = matmul3(quaternion_to_matrix(dq), gt_r)
    ref_t = gt_t + noise
    dev = renderer.mesh_bank.device
    real = renderer(gt_r.to(dev), gt_t.to(dev), k.to(dev), labels.to(dev))
    return {
        "real_images": (real["images"] * 255).round().to(torch.uint8),
        "ref_rotations": ref_r.to(dev), "ref_translations": ref_t.to(dev),
        "k": k.to(dev), "labels": labels.to(dev),
    }


def phase_k1(renderer, batch) -> dict:
    import torch

    from scflow_torch.ops import rasterize_fast as rf

    h, w = renderer.image_size
    inp = renderer.rasterizer_inputs(batch["ref_rotations"],
                                     batch["ref_translations"], batch["k"],
                                     batch["labels"].long())
    coeff, sel, attr, d = rf.tile_inputs(inp["tri_xy"], inp["tri_z"],
                                         inp["face_valid"], h, w,
                                         inp["tri_attrs"])
    key, zbuf, attrs = rf.rasterize_tiles(coeff, sel, attr, h, w, d)
    key_r, zbuf_r, attrs_r = rf.rasterize_tiles_reference(coeff, sel, attr,
                                                          h, w, d)
    torch.cuda.synchronize()
    agree = key == key_r
    mismatch = (~agree).float().mean().item()
    covered = (key_r < rf.BIG_KEY) & agree
    z_err = (zbuf - zbuf_r)[agree].abs().max().item()
    z_rel = ((zbuf - zbuf_r).abs() / zbuf_r.abs().clamp_min(1.0))[agree].max().item()
    a_err = (attrs - attrs_r)[agree].abs().max().item()
    a_scale = attrs_r.abs().amax(dim=(0, 1, 2))
    a_rel = ((attrs - attrs_r).abs() / a_scale)[agree].max().item()
    check(covered.any().item(), "k1: nothing rendered")
    check(mismatch <= 0.002, f"k1: key mismatch {mismatch} > 0.2%")
    check(z_rel <= 2e-4, f"k1: zbuf rel err {z_rel} > 2e-4")
    check(a_rel <= 2e-4, f"k1: attrs err {a_rel} of range > 2e-4")

    ms = median_ms(lambda: rf.rasterize_tiles(coeff, sel, attr, h, w, d),
                   KERNEL_REPS)
    plain_ms = median_ms(
        lambda: rf.rasterize_tiles_reference(coeff, sel, attr, h, w, d), 5, 1)
    n, t, k = sel.shape
    pairs = (sel >= 0).sum().item() * rf.TILE * rf.TILE
    moved = (coeff.numel() + sel.numel() + attr.numel()
             + key.numel() * 2 + attrs.numel()) * 4
    b_ms, b_by = bound_ms(moved, pairs * K1_OPS_PER_PAIR)
    row = dict(name="rasterize_tiles", route="cuda",
               source="scflow_torch/ops/csrc/rasterize.cu",
               replaces="scflow_tpu/ops/rasterize_fast.py:122",
               max_abs_err=max(z_err, a_err), ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    emit(phase="k1", batch=n, tiles=t, k=k, faces=coeff.shape[1], d_attr=d,
         pixel_face_pairs=pairs, key_mismatch_share=mismatch,
         keys_bit_equal=bool(agree.all().item()), zbuf_max_abs_err=z_err,
         attrs_max_abs_err=a_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
         bound_by=b_by)
    return row


def phase_k2() -> dict:
    import torch
    import torch.nn.functional as F

    from scflow_torch.ops.fused_norm import (instance_norm_fwd,
                                             instance_norm_reference)

    g = torch.Generator().manual_seed(1)
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                  bytes=0.0, ops=0.0)
    worst = 0.0
    # (channels, side): the three IN shapes of a feature-encoder pass, 5 each
    for c, side in ((64, 128), (96, 64), (128, 32)):
        x32 = (torch.randn(BATCH, c, side, side, generator=g) * 2 + 0.5).cuda()
        scale = (1 + 0.3 * torch.randn(c, generator=g)).cuda()
        bias = (0.2 * torch.randn(c, generator=g)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            y = instance_norm_fwd(x, scale, bias)
            y_ref = instance_norm_reference(x, scale, bias)
            torch.cuda.synchronize()
            diff = (y.float() - y_ref.float()).abs()
            err = diff.max().item()
            if dtype == torch.float32:     # statistics summed in another order
                ok = bool((diff <= 1e-5 + 1e-5 * y_ref.abs()).all())
            else:        # f32 statistics' spread, then one bf16 rounding step
                ok = bool((diff <= 1e-5 + bf16_ulp(y_ref)).all())
            check(ok, f"k2 {dtype} {tuple(x.shape)}: max err {err}")
            xs = cold_inputs(x)
            ms = median_ms(lambda: instance_norm_fwd(next(xs), scale, bias),
                           KERNEL_REPS)
            plain = median_ms(
                lambda: instance_norm_reference(next(xs), scale, bias),
                KERNEL_REPS)
            lib = None
            if dtype == torch.float32:
                lib = median_ms(lambda: F.instance_norm(
                    next(xs), weight=scale, bias=bias, eps=1e-5), KERNEL_REPS)
            del xs
            moved = 2 * x.numel() * x.element_size()
            b_ms, b_by = bound_ms(moved, x.numel() * K2_OPS_PER_ELEM)
            emit(phase="k2", shape=list(x.shape), dtype=str(dtype),
                 max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                 bound_ms=b_ms, bound_by=b_by)
            if dtype == torch.float32:
                worst = max(worst, err)
                # 10 launches of this shape per eval step (5 per encoder pass)
                for key, v in (("ms", ms), ("plain_ms", plain),
                               ("library_ms", lib), ("bound_ms", b_ms),
                               ("bytes", moved), ("ops",
                                                  x.numel() * K2_OPS_PER_ELEM)):
                    totals[key] += 10 * v
    b_ms, b_by = bound_ms(totals["bytes"], totals["ops"])
    return dict(name="instance_norm_fwd", route="cuda",
                source="scflow_torch/ops/csrc/instance_norm.cu",
                replaces="scflow_tpu/ops/fused_norm.py:39",
                max_abs_err=worst, ms=totals["ms"],
                plain_ms=totals["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                library_ms=totals["library_ms"])


def reset_counts() -> None:
    from scflow_torch.ops.fused_norm import instance_norm_fwd
    from scflow_torch.ops.rasterize_fast import rasterize_tiles

    rasterize_tiles.launches = 0
    instance_norm_fwd.launches = 0


def counts() -> tuple[int, int]:
    from scflow_torch.ops.fused_norm import instance_norm_fwd
    from scflow_torch.ops.rasterize_fast import rasterize_tiles

    return rasterize_tiles.launches, instance_norm_fwd.launches


def run_path(name: str, step, batch, steps: int, renders: int) -> dict:
    """Drive one path ``steps`` times with the counts at 0 just before;
    check K1 = renders and K2 = 30·renders launches per step."""
    import torch

    reset_counts()
    times = []
    out = None
    for _ in range(steps):
        t0 = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    k1, k2 = counts()
    check(k1 == renders * steps, f"{name}: K1 launched {k1}, want "
          f"{renders * steps}")
    check(k2 == 30 * renders * steps, f"{name}: K2 launched {k2}, want "
          f"{30 * renders * steps}")
    for key, v in out.items():
        check(bool(torch.isfinite(v).all()), f"{name}: {key} not finite")
    moved = (out["translations"] - batch["ref_translations"]).abs().max()
    check(moved.item() > 1e-3, f"{name}: pose did not move")
    return dict(out=out, times=times, k1=k1, k2=k2)


def phase_profile(model, renderer, cfg, step, batch) -> None:
    """Where a main-path step's time goes: its stages timed alone with CUDA
    events, then two steps under torch.profiler (kernel time by name, and
    the share of the wall time in which some kernel ran)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from scflow_torch.training import device_normalize_images, render_at_pose

    with torch.inference_mode():
        labels = batch["labels"].long()
        args = (batch["ref_rotations"], batch["ref_translations"], batch["k"],
                labels)

        def render():
            return render_at_pose(renderer, *args, cfg.data.normalize_mean,
                                  cfg.data.normalize_std)

        rendered, depth, _ = render()
        real = device_normalize_images(batch["real_images"], cfg)
        nchw = [x.permute(0, 3, 1, 2).contiguous() for x in (rendered, real)]
        feats = model.extract_feat(*nchw)

        def decode():
            return model.decoder(*feats, batch["ref_rotations"],
                                 batch["ref_translations"], depth, batch["k"],
                                 labels, iters=cfg.model.test_iters,
                                 lowres=True)

        stages = {"render_ms": median_ms(render, 5),
                  "encoders_ms": median_ms(lambda: model.extract_feat(*nchw), 5),
                  "decoder_ms": median_ms(decode, 3)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / 2
    # kernels only (aten ops also report their kernels' device time); busy
    # time is the union of kernel intervals, as cuDNN overlaps some kernels
    def is_kernel(e, name):
        return e.device_type == DeviceType.CUDA and name not in (
            "Buffer Flush", "Activity Buffer Request")

    busy_us, end = 0.0, -math.inf
    for s0, s1 in sorted((e.time_range.start, e.time_range.end)
                         for e in prof.events() if is_kernel(e, e.name)):
        busy_us += max(0.0, s1 - max(s0, end))
        end = max(end, s1)
    busy_ms = busy_us / 1e3 / 2
    kernels = [e for e in prof.key_averages() if is_kernel(e, e.key)]
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    emit(phase="profile", **stages, step_wall_ms=wall_ms,
         device_busy_ms=busy_ms, device_busy_share=busy_ms / wall_ms,
         top_kernels=[{"name": e.key[:90],
                       "ms_per_step": e.self_device_time_total / 1e3 / 2,
                       "calls_per_step": e.count / 2} for e in top])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    from scflow_torch.ops import _build
    from scflow_torch.rendering import Renderer, make_test_meshes
    from scflow_torch.training import (Config, ModelConfig, build_model,
                                       make_eval_step,
                                       make_multi_pass_eval_step)

    t_start = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit(phase="env", gpu=kind, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0], tf32=False)

    t0 = time.perf_counter()
    _build.library()
    ptxas = [ln.strip() for ln in _build.build_info.get("log", "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit(phase="build", seconds=time.perf_counter() - t0,
         library=_build.build_info["path"], ptxas=ptxas)

    cfg = Config(model=ModelConfig(num_class=NUM_CLASS, iters=ITERS,
                                   test_iters=ITERS))
    bank = make_test_meshes(NUM_CLASS, subdivisions=3, radius=60.0,
                            device="cuda")
    renderer = Renderer(bank, image_size=SIZE)
    with torch.inference_mode():
        batch = make_batch(renderer, BATCH, seed=0)
        rows = [phase_k1(renderer, batch), phase_k2()]

    model = build_model(cfg, device="cuda", seed=0)
    step = make_eval_step(model, renderer, cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    run_path("warmup", step, batch, WARMUP, renders=1)
    main_run = run_path("main", step, batch, STEPS, renders=1)
    rows[0]["launches"], rows[1]["launches"] = main_run["k1"], main_run["k2"]
    step_ms = 1e3 * statistics.median(main_run["times"])

    # the same 2 samples through the port on the CPU: plain versions
    cpu_model = build_model(cfg, device="cpu", seed=0)
    cpu_renderer = Renderer(make_test_meshes(NUM_CLASS, subdivisions=3,
                                             radius=60.0, device="cpu"),
                            image_size=SIZE)
    cpu_step = make_eval_step(cpu_model, cpu_renderer, cfg, device="cpu")
    t0 = time.perf_counter()
    cpu_out = cpu_step({k: v[:2].cpu() for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    gpu_out = main_run["out"]
    rot_err = (gpu_out["rotations"][:2].cpu() - cpu_out["rotations"]).abs().max().item()
    t_diff = (gpu_out["translations"][:2].cpu() - cpu_out["translations"]).abs()
    t_allow = POSE_TOL["trans_atol"] + POSE_TOL["trans_rtol"] * cpu_out["translations"].abs()
    check(rot_err <= POSE_TOL["rot_atol"], f"cpu parity: rotation err {rot_err}")
    check(bool((t_diff <= t_allow).all()),
          f"cpu parity: translation err {t_diff.max().item()}")
    emit(phase="main", batch=BATCH, image=list(SIZE), classes=NUM_CLASS,
         iters=ITERS, lowres=True, dtype="float32", steps=STEPS,
         step_ms_median=step_ms, step_ms=[1e3 * t for t in main_run["times"]],
         frames_per_s=BATCH / (step_ms / 1e3),
         launches_per_step={"rasterize_tiles": main_run["k1"] // STEPS,
                            "instance_norm_fwd": main_run["k2"] // STEPS},
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         cpu_parity={"samples": 2, "rotation_max_abs_err": rot_err,
                     "translation_max_abs_err": t_diff.max().item(),
                     "cpu_seconds": cpu_s, **POSE_TOL})

    phase_profile(model, renderer, cfg, step, batch)

    full_cfg = Config(model=ModelConfig(num_class=NUM_CLASS, iters=ITERS,
                                        test_iters=ITERS, lowres_eval=False))
    full = run_path("fullres", make_eval_step(model, renderer, full_cfg,
                                              device="cuda"), batch, 1, 1)
    two = run_path("two_pass", make_multi_pass_eval_step(
        model, renderer, cfg, passes=2, device="cuda"), batch, 1, 2)
    emit(phase="paths", fullres_ms=1e3 * full["times"][0],
         fullres_launches=[full["k1"], full["k2"]],
         two_pass_ms=1e3 * two["times"][0],
         two_pass_launches=[two["k1"], two["k2"]],
         seconds_total=time.perf_counter() - t_start)

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
