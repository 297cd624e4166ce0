#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SCFlow (``scflow_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases (each prints one JSON line; any failed check raises):
  env     card name and power limit, torch/CUDA versions; TF32 off.
  build   compile the hand-written kernels (``scflow_torch/ops/csrc``).
  k1      tile rasterizer kernel vs its plain PyTorch version on the main
          path's render (batch 32, 256², 21-class bench bank): face ids, z
          and attributes must be bit-equal; times.
  k2      instance-norm kernel vs its plain version at the encoders' three
          shapes (batch 32), f32 and bf16; times, and F.instance_norm's,
          each call on an input copy that is not in L2.
          A kernel's ``ms`` is its device time (``device_ms``: many calls
          queued back to back behind a spin kernel, so host time overlaps
          the device's); ``call_ms`` is one call of the wrapper between two
          events, host time included.
  main    the eval step at batch 32, 21 classes, 256², 8 iterations,
          lowres, f32, seeded weights: launch counts, finite outputs, a
          moved pose, step time; the same 2 samples through the port on the
          CPU must agree; one full-res step and one 2-pass step.
  profile the main path's stages timed alone (one call each, host time
          included; the render's kernel time and launches under
          torch.profiler), and the step's kernels by device time.
  paths   one full-res eval step and one 2-pass eval step.
  k2_bwd  instance-norm backward kernel vs its plain version at the
          encoders' three shapes at the train batch (16), f32 and bf16, on
          input copies not in L2; times, and F.instance_norm's autograd
          backward's.
  train   the train step at batch 16, 21 classes, 256², 8 iterations,
          full-res flow, f32, seeded weights, on one synthetic batch: 2
          warm-up and 8 timed steps with launch counts (K1 1, K2 forward 30,
          K2 backward 30 per step), finite metrics, moved parameters and BN
          statistics, step time, peak memory and one profiled step's top
          kernels; the loss and gradients of 2 samples against the port on
          the CPU; one 2-cycle step.
  trainer ``python -m scflow_torch.train --synthetic`` through
          ``scflow_torch.train.main`` at the train phase's width (batch 16,
          256², ``make_test_meshes(21, subdivisions=2)``, 8 iterations,
          f32): 6 fit steps with the on-device ADD(-S) eval and panels
          every 3; fit-step time beside the train phase's, eval, panel and
          checkpoint times, launches per train step (K1 1, K2 30 and 30);
          the JSONL log, checkpoint steps [6], the panel PNG's header and
          the TB records' CRCs; a fresh Trainer's ``resume`` restores every
          tensor bit for bit and its next step's loss is bit-equal; the
          eval of 2 samples on the card and on the CPU; ``predict`` equal
          to the bare eval step.
  bf16    the main path's eval step with ``dtype="bfloat16"``: launches
          per step (K1 1, K2 30, every K2 input bf16), step time, frames/s,
          peak memory; the card's bf16 poses of 2 samples within 3× the
          CPU's bf16-vs-f32 gap of the CPU's bf16 poses.
  train_bf16  the train step in bf16 (batch 16): 2 warm-up and 4 timed
          steps, launches per step (K2 backward 30 on bf16), finite
          metrics, moved parameters, step time, peak memory.
  raft    the RAFT eval step at the raft_ycbv width (flow + occlusion, 12
          iterations, RANSAC-EPnP: 1024 points, 64 hypotheses) at batch 32,
          256², f32: launches per step, step time, the network and PnP
          stages timed alone, the share of solved samples; the flows and
          occlusions of 2 samples against the CPU; PnP on the exact flow to
          the GT pose, the same draws on the card and the CPU, within 0.5°
          and 5 mm of the GT pose.
  raft_train  the RAFT train step (raft_loss) at batch 16: 2 warm-up and 3
          timed steps, launches per step, finite metrics, moved parameters.
  sync    one f32 eval step of the main path, its batch already on the
          card, then the eval loop's pose-graph pass over its outputs
          (images of 4 slots) and one ``make_masked_metric_step``, under
          ``torch.cuda.set_sync_debug_mode``: "warn" lists any
          synchronising call by file and line, then "error" must raise
          nothing (they copy nothing from the host).
  eval_bop  the BOP eval CLI: ``scflow_torch.tools.make_synthetic_bop``
          writes 48 images at 640×480 with 3–6 of 21 classes each on the
          card, then ``scflow_torch.test.main`` evaluates them at the CLI's
          width (256², 8 iterations, lowres, slot budget 16, f32) with
          ``--save-dir``: the tree's write time, images, objects, packed
          batches and the share of slots used, the loop's wall time and
          rates beside batches × one packed step's time, the host time per
          image to decode and crop, the host time of the metric's matching
          and ADD(-S), launches per packed batch (K1 1, K2 30), the metric;
          every image has a record, every GT object an instance, the BOP
          file reads back equal to the poses, and the first 2 images
          evaluated again on the CPU agree (poses within POSE_TOL, ADD(-S)
          records within EVAL_ERR_RTOL or what the pose gap can move
          them). Also one 640×480 Paeth-filtered PNG
          decoded by the port's reader, timed.
  train_bop  training from a BOP tree on disk: ``make_synthetic_bop``
          writes a train_real split (48 images at 640×480, 3–6 of 21
          classes) and an 8-image test split on the card, laid out as the
          ``scflow_ycbv_real`` recipe reads them, and 4 PNG backgrounds;
          ``scflow_torch.train.main --config scflow_ycbv_real`` (batch 16,
          256², 8 iterations, f32, color augmentation, backgrounds and
          both occlusions at p 0.3) runs 6 steps with the on-disk eval
          every 3, then ``--scene`` (4 images × 4 slots) 2 steps: finite
          losses, launches per fit step (K1 1, K2 30 and 30), the eval's
          ``num_instances`` = the test split's objects, neither cv2 nor PIL
          imported, one disk batch's loss and gradient against the CPU
          port (``train_parity``'s bound); fit-step time beside the bare
          step's, and the loader's samples/s alone and through
          ``prefetch`` with ms per sample to decode, crop and augment, on
          the tool's frames and on Paeth-filtered copies.
  train_pbr  JPEG without cv2, and the PBR recipes: the host library's
          build time; every committed JPEG fixture
          (``tests/torch_fixtures/jpeg``) decoded color and gray against
          the sha256 of cv2's arrays in its manifest; host ms per 640×480
          frame on 1 and 3 threads, beside the host CPU's name; the tool
          writes an 8-image ``train_pbr`` split on the card (the fixture
          frames' seed and arguments) whose frames become the JPEG
          fixtures, and an 8-image PNG ``train_real`` split; with the 3
          JPEG backgrounds as ``data/coco``,
          ``scflow_torch.train.main --config scflow_ycbv_mixpbr`` (batch
          16, 256², 8 iterations, f32, the recipe's backgrounds and
          occlusion at p 0.3) runs 4 steps: launches per fit step (K1 1,
          K2 30 and 30), finite losses, neither cv2 nor PIL imported, a
          disk batch's loss and gradient against the CPU; fit-step time
          beside the bare step's, the loader's samples/s alone and through
          ``prefetch`` with decode ms per sample.
  pose_graph  ``test.py --pose-graph``: the eval_bop tree written again
          from its seed, ``scflow_torch.test.main --pose-graph`` at the
          CLI's width (256², 8 iterations, lowres, slot budget 16, f32,
          camera-only graph): launches per packed batch (K1 1, K2 30), the
          plain poses against eval_bop's (POSE_TOL), both metrics and the
          averages' change, images of 2 or more objects, the pass's ms per
          packed batch and per such image (timed between two syncs), and
          the first batch's pass again on the CPU on the card's network
          outputs (its first 2 such images' refined poses within
          POSE_TOL).
  parallel  the parallel layer on one card: ``initialize_distributed``
          of one process starts no group; a world-1 NCCL group started
          here carries 2 ``Trainer.fit`` steps of the
          data-parallel path at the train phase's width (batch 16, 256²,
          21 classes, 8 iterations, f32) against 2 plain train steps on
          the same batch: the first loss bit-equal, the second within
          1e-4, the parameters within 2.5·(lr₀ + lr₁), launches per fit
          step K1 1, K2 30 and 30; ``graft_entry.entry()``'s forward and
          ``dryrun_multichip(1)`` (one spawned NCCL rank).
  options  every ModelConfig option past the shipped recipe, and the
          renderer's depth/mask-only form: the K2 forward against its
          plain version at the Small encoder's four IN shapes (batch 32,
          f32); K1's no-attribute form against
          its plain version bit for bit at batch 32 on the main path's
          crops (256²) and on 480×640 frames of YCB-V's camera, device and
          call time beside the bound; ``Renderer(render_image=False,
          render_mask=True, soft_blending=True)`` at both sizes, 3 renders
          each (launches: that form once per render, nothing else), 2
          samples against the CPU; the tile kernel, binned and scan passes
          on the same faces (face ids equal; scan within JAX's 1e-3 share
          of edge tie-breaks) and one render with each, timed; the eval
          step at batch 32 under option set A (separate encoders,
          quaternion, linear depth not detached in x/y, masked flow and
          correlation), the Small net and RAFT with the Small net
          (bilinear upsampling, 12 iterations), 1 warm-up and 3 steps each
          (K1 1, K2 30 / 32 / 32 per step), 2 samples against the CPU
          (SCFlow poses to POSE_TOL, RAFT's flows and occlusions, and a
          control: RAFT's flow with K2's output off by 1e-4 of itself must
          fail that flow bound); the
          train step at batch 16 under A with ``remat`` (1 warm-up, 2
          steps, K1 1, K2 30 and 30), loss and gradient against the CPU.
Then the ``kernels`` line (K1 and its no-attribute form, the K2 forward
and backward in f32 and in bf16, each with its launches on every path),
the card line from nvidia-smi and, last, ``{"ok": true, "device":
{...}}``. Exits non-zero without a CUDA GPU.
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
TRAIN_BATCH = 16          # the JAX DataConfig.batch_size default
SIZE = (256, 256)
NUM_CLASS = 21
ITERS = 8
WARMUP, STEPS = 2, 10
TRAIN_WARMUP, TRAIN_STEPS = 2, 8
KERNEL_REPS = 20
# H100 SXM peaks (NVIDIA data sheet, dense): FP32 CUDA cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
L2_BYTES = 50 * 2 ** 20   # H100 L2 cache
K1_OPS_PER_PAIR = 22      # counted in csrc/rasterize.cu
K1_COEFF_USED = 14        # coefficients a face's pass reads: edges, z, id, ok
K2_OPS_PER_ELEM = 8       # sum, centred square, normalise, affine
K2_BWD_OPS_PER_ELEM = 16  # statistics 4, the two sums 5, dx 7
# the three IN shapes of a feature-encoder pass (channels, side), 5 each;
# a step runs two passes, so 10 launches of each shape
IN_SHAPES = ((64, 128), (96, 64), (128, 32))
# tolerances of the CPU parity tests (tests/test_torch_port_*.py)
POSE_TOL = dict(rot_atol=2e-3, trans_rtol=2e-3, trans_atol=2e-4)
# bf16: the card's poses within this multiple of the CPU's own bf16-vs-f32
# gap of the CPU's bf16 poses (two bf16 roundings apart, each ~1 gap)
BF16_GAP_MULT = 3.0
BF16_TRAIN_STEPS = 4
# RAFT (the raft_ycbv recipe): 12 iterations; the network's flows and
# occlusions against the CPU at the CPU tests' bounds
RAFT_ITERS = 12
RAFT_STEPS, RAFT_TRAIN_STEPS = 5, 3
RAFT_FLOW_TOL = dict(rtol=2e-3, atol=2e-3)
RAFT_OCC_TOL = dict(rtol=0.0, atol=1e-3)
# trainer: fit steps, eval and panel interval; card vs CPU ADD(-S) errors
TRAINER_STEPS, TRAINER_EVERY = 6, 3
EVAL_ERR_RTOL = 1e-3
# eval_bop: the synthetic tree (YCB-V's frame; its test images hold ~4.6
# objects on average) and the CLI's packing budget
BOP_IMAGES, BOP_FRAME, BOP_OBJECTS, BOP_BUDGET = 48, (480, 640), (3, 6), 16
BOP_CPU_IMAGES = 2
# train_bop: a train_real split of YCB-V's frame and a test split with
# initial poses, laid out as the scflow_ycbv_real recipe reads them; PNG
# backgrounds; the recipe run's steps and eval interval, the scene run's;
# batches timed for the loader alone and through prefetch
TRAIN_BOP_IMAGES, TRAIN_BOP_TEST_IMAGES, TRAIN_BOP_BACKGROUNDS = 48, 8, 4
TRAIN_BOP_STEPS, TRAIN_BOP_EVERY, TRAIN_BOP_SCENE_STEPS = 6, 3, 2
TRAIN_BOP_OCCLUSION_P = 0.3
LOADER_BATCHES = {"filter0": (2, 6), "paeth": (1, 2)}   # (alone, prefetch)
# train_pbr: the committed JPEG fixtures (cv2's digests in their
# manifest); the scflow_ycbv_mixpbr recipe over a JPEG train_pbr split (the
# fixture frames), a PNG train_real split and the JPEG backgrounds as
# data/coco; fit steps; decode threads timed; loader batches (alone,
# prefetch: a multiple of its 3 workers, or the last round runs part-full)
JPEG_FIXTURES = "tests/torch_fixtures/jpeg"
TRAIN_PBR_IMAGES, TRAIN_PBR_REAL_IMAGES, TRAIN_PBR_STEPS = 8, 8, 4
DECODE_THREADS, DECODE_REPS = (1, 3), 6
PBR_LOADER_BATCHES = (2, 6)
# a step after resume, live vs restored state: the loss is bit-equal (a
# deterministic forward); cuDNN's backward may sum in another order, so
# the parameters are held to Adam's step bound (2.5 lr per element) and
# their difference to 0.1 of the update's norm
RESUME_LR_MULT, RESUME_UPDATE_RTOL = 2.5, 0.1
# options: the ModelConfig options past the shipped recipe (set A), the
# Small net, and the depth/mask-only render at the crop and at YCB-V's
# frame and camera (BOP ycbv camera_uw.json)
OPTIONS_A = dict(separate_encoder=True, rotation_mode="quaternion",
                 depth_transform="linear", detach_depth_for_xy=False,
                 mask_flow=True, mask_corr=True)
OPTIONS_STEPS = 3
# a Small encoder pass runs 16 instance norms (layer 1's first block
# changes width, so it has a downsample), a step two passes
SMALL_K2_PER_STEP = 32
# the IN shapes (channels, side) of a Small feature-encoder pass at 256²:
# the stem, then each stage's width
SMALL_IN_SHAPES = ((32, 128), (8, 128), (16, 64), (24, 32))
# the control of RAFT Small's flow bound: the card's flow with every IN
# output scaled by 1 + this (10× K2's f32 tolerance) must fall outside it
K2_CONTROL_REL = 1e-4
FRAME = (480, 640)
YCBV_K = ((1066.778, 0.0, 312.9869), (0.0, 1067.487, 241.3109),
          (0.0, 0.0, 1.0))
SIL_TOL = 1e-4            # soft silhouette, card vs CPU (the CPU tests')
# scan vs tile face ids: the JAX package's own share of exact-edge
# tie-breaks between its rasterizers (tests/test_render_modes.py)
RASTER_MISMATCH = 1e-3


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def call_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median of ``reps`` single-call CUDA-event timings after warm-up. The
    events bracket one call of the Python wrapper on an idle stream, so
    its host time (checks, allocation, the launch itself) is counted."""
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


def device_ms(fn, reps: int, trials: int = 5, warmup: int = 3) -> float:
    """A call's device time: CUDA events around ``reps`` calls queued back
    to back, divided by ``reps``; the median of ``trials`` such runs.

    A spin kernel (``torch.cuda._sleep``) queued before the start event
    holds the device while the host queues the calls, so the wrappers'
    Python runs ahead of the device instead of between its launches. The
    spin is lengthened until the start event is still pending when the
    last call has been queued. A function of more launches than the launch
    queue holds can never be queued ahead of the device: time it with
    :func:`call_ms`."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 1 << 20                       # cycles, ~0.6 ms
    times = []
    while len(times) < trials:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead:
            times.append(start.elapsed_time(end) / reps)
        else:
            check(spin < 1 << 28, "device_ms: the host never got ahead")
            spin *= 4
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
    """Seeded scene: 'real' uint8 crops rendered at a random (GT) pose, and
    the initial pose that pose jittered (15° / (15, 15, 50) mm, clipped)."""
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
        "gt_rotations": gt_r.to(dev), "gt_translations": gt_t.to(dev),
    }


def tile_pass_args(renderer, batch, translations) -> tuple:
    """``rasterize_tiles``'s arguments for the batch's objects at
    ``translations``."""
    from scflow_torch.ops import rasterize_fast as rf

    h, w = renderer.image_size
    inp = renderer.rasterizer_inputs(batch["ref_rotations"], translations,
                                     batch["k"], batch["labels"].long())
    coeff, bbox, attr, d, k = rf.tile_inputs(
        inp["tri_xy"], inp["tri_z"], inp["face_valid"], h, w, inp["tri_attrs"])
    return coeff, bbox, attr, h, w, d, k


def phase_k1(renderer, batch) -> dict:
    import torch

    from scflow_torch.ops import rasterize_fast as rf

    args = tile_pass_args(renderer, batch, batch["ref_translations"])
    coeff, bbox, attr, h, w, d, k = args
    got = rf.rasterize_tiles(*args)
    want = rf.rasterize_tiles_reference(*args)
    torch.cuda.synchronize()
    names = ("face_id", "zbuf", "attrs")
    bits = {name: torch.equal(a.view(torch.int32), b.view(torch.int32))
            for name, a, b in zip(names, got, want)}
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got[1:], want[1:]))
    check(bool((want[0] >= 0).any()), "k1: nothing rendered")
    check(all(bits.values()), f"k1: not bit-equal to the plain version {bits}")

    ms = device_ms(lambda: rf.rasterize_tiles(*args), KERNEL_REPS)
    one = call_ms(lambda: rf.rasterize_tiles(*args), KERNEL_REPS)
    # ~1600 small launches a call: more than the launch queue holds
    plain_ms = call_ms(lambda: rf.rasterize_tiles_reference(*args), 3, 1)
    # the same work whatever implements it: of each face, the coefficients
    # the pass uses and its 3·d_attr attribute floats read once, each output
    # written once; 22 operations per filled (pixel, slot) pair
    sel = rf._select_tiles(bbox.unbind(-1), coeff[..., 14] > 0, h, w, k)
    pairs = (sel >= 0).sum().item() * rf.TILE * rf.TILE
    faces = coeff.shape[0] * coeff.shape[1]
    moved = (faces * (K1_COEFF_USED + 3 * d) * 4
             + sum(x.numel() * 4 for x in got))
    b_ms, b_by = bound_ms(moved, pairs * K1_OPS_PER_PAIR)
    row = dict(name="rasterize_tiles", route="cuda",
               source="scflow_torch/ops/csrc/rasterize.cu",
               replaces="scflow_tpu/ops/rasterize_fast.py:122",
               max_abs_err=err, ms=ms, call_ms=one, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    emit(phase="k1", batch=coeff.shape[0], tiles=sel.shape[1], k=k,
         faces=coeff.shape[1], d_attr=d, pixel_face_pairs=pairs,
         bit_equal=bits, max_abs_err=err, ms=ms, call_ms=one,
         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, bytes=moved)
    return row


def _totals() -> dict:
    return {dt: dict(ms=0.0, call_ms=0.0, plain_ms=0.0, library_ms=0.0,
                     bytes=0.0, ops=0.0, worst=0.0) for dt in ("f32", "bf16")}


def _kernel_rows(name: str, replaces: str, totals: dict) -> list:
    """One kernels-line row per dtype from per-step ``totals``."""
    rows = []
    for dt, tot in totals.items():
        b_ms, b_by = bound_ms(tot["bytes"], tot["ops"])
        rows.append(dict(
            name=name if dt == "f32" else f"{name}[bf16]", route="cuda",
            source="scflow_torch/ops/csrc/instance_norm.cu",
            replaces=replaces, max_abs_err=tot["worst"], ms=tot["ms"],
            call_ms=tot["call_ms"], plain_ms=tot["plain_ms"], bound_ms=b_ms,
            bound_by=b_by, library_ms=tot["library_ms"]))
    return rows


def k2_fwd_check(x, scale, bias, what: str) -> float:
    """``instance_norm_fwd`` on ``x`` against its plain version: f32 within
    1e-5 + 1e-5·|y| (statistics summed in another order), bf16 within 1e-5
    plus one bf16 rounding step. Raises past it; returns the max abs
    error."""
    import torch

    from scflow_torch.ops.fused_norm import (instance_norm_fwd,
                                             instance_norm_reference)

    y = instance_norm_fwd(x, scale, bias)
    y_ref = instance_norm_reference(x, scale, bias)
    torch.cuda.synchronize()
    diff = (y.float() - y_ref.float()).abs()
    err = diff.max().item()
    if x.dtype == torch.float32:
        ok = bool((diff <= 1e-5 + 1e-5 * y_ref.abs()).all())
    else:
        ok = bool((diff <= 1e-5 + bf16_ulp(y_ref)).all())
    check(ok, f"{what} {x.dtype} {tuple(x.shape)}: max err {err}")
    return err


def phase_k2() -> list:
    """Rows for the f32 and the bf16 forward, per step (10 launches of
    each encoder shape at the eval batch)."""
    import torch
    import torch.nn.functional as F

    from scflow_torch.ops.fused_norm import (instance_norm_fwd,
                                             instance_norm_reference)

    g = torch.Generator().manual_seed(1)
    totals = _totals()
    for c, side in IN_SHAPES:
        x32 = (torch.randn(BATCH, c, side, side, generator=g) * 2 + 0.5).cuda()
        scale = (1 + 0.3 * torch.randn(c, generator=g)).cuda()
        bias = (0.2 * torch.randn(c, generator=g)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            err = k2_fwd_check(x, scale, bias, "k2")
            xs = cold_inputs(x)
            ms = device_ms(lambda: instance_norm_fwd(next(xs), scale, bias),
                           KERNEL_REPS)
            one = call_ms(lambda: instance_norm_fwd(next(xs), scale, bias),
                          KERNEL_REPS)
            plain = device_ms(
                lambda: instance_norm_reference(next(xs), scale, bias),
                KERNEL_REPS)
            # f32 (C,) affine parameters with a bf16 input, as the port's
            lib = device_ms(lambda: F.instance_norm(
                next(xs), weight=scale, bias=bias, eps=1e-5), KERNEL_REPS)
            del xs
            moved = 2 * x.numel() * x.element_size()
            b_ms, b_by = bound_ms(moved, x.numel() * K2_OPS_PER_ELEM)
            emit(phase="k2", shape=list(x.shape), dtype=str(dtype),
                 max_abs_err=err, ms=ms, call_ms=one, plain_ms=plain,
                 library_ms=lib, bound_ms=b_ms, bound_by=b_by)
            tot = totals["f32" if dtype == torch.float32 else "bf16"]
            tot["worst"] = max(tot["worst"], err)
            # 10 launches of this shape per eval step (5 per encoder pass)
            for key, v in (("ms", ms), ("call_ms", one), ("plain_ms", plain),
                           ("library_ms", lib), ("bytes", moved),
                           ("ops", x.numel() * K2_OPS_PER_ELEM)):
                tot[key] += 10 * v
    return _kernel_rows("instance_norm_fwd", "scflow_tpu/ops/fused_norm.py:39",
                        totals)


def reset_counts() -> None:
    from scflow_torch.ops.fused_norm import instance_norm_bwd, instance_norm_fwd
    from scflow_torch.ops.rasterize_fast import rasterize_tiles

    rasterize_tiles.launches = 0
    rasterize_tiles.bare_launches = 0
    instance_norm_fwd.launches = 0
    instance_norm_bwd.launches = 0


def counts() -> tuple[int, int, int]:
    """Launches of K1, the K2 forward and the K2 backward since the reset."""
    from scflow_torch.ops.fused_norm import instance_norm_bwd, instance_norm_fwd
    from scflow_torch.ops.rasterize_fast import rasterize_tiles

    return (rasterize_tiles.launches, instance_norm_fwd.launches,
            instance_norm_bwd.launches)


def run_path(name: str, step, batch, steps: int, renders: int,
             moves: bool = True, k2_per_render: int = 30) -> dict:
    """Drive one path ``steps`` times with the counts at 0 just before;
    check K1 = renders and K2 = ``k2_per_render``·renders launches per
    step (30: two passes of a Basic feature encoder), finite outputs and
    (``moves``) a moved pose."""
    import torch

    reset_counts()
    times = []
    out = None
    for _ in range(steps):
        t0 = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    k1, k2, k2b = counts()
    check(k2b == 0, f"{name}: the K2 backward ran {k2b} times in inference")
    check(k1 == renders * steps, f"{name}: K1 launched {k1}, want "
          f"{renders * steps}")
    want_k2 = k2_per_render * renders * steps
    check(k2 == want_k2, f"{name}: K2 launched {k2}, want {want_k2}")
    for key, v in out.items():
        check(bool(torch.isfinite(v).all()), f"{name}: {key} not finite")
    moved = (out["translations"] - batch["ref_translations"]).abs().max()
    check(not moves or moved.item() > 1e-3, f"{name}: pose did not move")
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

        stages = {"render_ms": call_ms(render, 5),
                  "encoders_ms": call_ms(lambda: model.extract_feat(*nchw), 5),
                  "decoder_ms": call_ms(decode, 3)}

    # kernels only (aten ops also report their kernels' device time); busy
    # time is the union of kernel intervals, as cuDNN overlaps some kernels
    def is_kernel(e, name):
        return e.device_type == DeviceType.CUDA and name not in (
            "Buffer Flush", "Activity Buffer Request")

    # the render's own device work: it synchronises with the host, so it
    # cannot be queued ahead for device_ms; sum its kernels instead
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            render()
        torch.cuda.synchronize()
    render_kernels = [e for e in prof.key_averages() if is_kernel(e, e.key)]
    stages["render_kernel_ms"] = sum(
        e.self_device_time_total for e in render_kernels) / 1e3 / 5
    stages["render_launches"] = sum(e.count for e in render_kernels) / 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / 2

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

def phase_k2_bwd() -> list:
    """Rows for the f32 and the bf16 backward, per train step (10 launches
    of each encoder shape at the train batch)."""
    import torch
    import torch.nn.functional as F

    from scflow_torch.ops.fused_norm import (instance_norm_bwd,
                                             instance_norm_bwd_reference)

    g = torch.Generator().manual_seed(2)
    totals = _totals()
    for c, side in IN_SHAPES:
        x32 = (torch.randn(TRAIN_BATCH, c, side, side, generator=g) * 2
               + 0.5).cuda()
        gy32 = torch.randn(TRAIN_BATCH, c, side, side, generator=g).cuda()
        scale = (1 + 0.3 * torch.randn(c, generator=g)).cuda()
        bias = (0.2 * torch.randn(c, generator=g)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            x, gy = x32.to(dtype), gy32.to(dtype)
            dx, dscale, dbias = instance_norm_bwd(x, gy, scale)
            want = instance_norm_bwd_reference(x, gy, scale)
            torch.cuda.synchronize()
            ref = want[0].float()
            diff = (dx.float() - ref).abs()
            err = diff.max().item()
            if dtype == torch.float32:     # sums in another order
                ok = bool((diff <= 1e-5 + 1e-5 * ref.abs()).all())
            else:        # f32 arithmetic's spread, then one bf16 rounding step
                ok = bool((diff <= 1e-5 + bf16_ulp(ref)).all())
            check(ok, f"k2_bwd {dtype} {tuple(x.shape)}: dx max err {err}")
            # dscale, dbias: 1e-5 of the sums of their terms' magnitudes
            xf = x.float()
            mu = xf.mean((2, 3), keepdim=True)
            xhat = (xf - mu) * torch.rsqrt(
                (xf - mu).square().mean((2, 3), keepdim=True) + 1e-5)
            sum_err = 0.0
            for got, ref_s, terms in ((dscale, want[1], gy.float() * xhat),
                                      (dbias, want[2], gy.float())):
                mag = terms.abs().sum((0, 2, 3))
                d = (got - ref_s).abs()
                check(bool((d <= 1e-5 * mag).all()),
                      f"k2_bwd {dtype} {tuple(x.shape)}: dscale/dbias err "
                      f"{d.max().item()}")
                sum_err = max(sum_err, (d / mag).max().item())
            copies = max(2, math.ceil(4 * L2_BYTES / (2 * x.numel()
                                                      * x.element_size())))
            pairs = itertools.cycle([(x, gy)] + [(x.clone(), gy.clone())
                                                 for _ in range(copies - 1)])

            def kernel():
                a, b = next(pairs)
                return instance_norm_bwd(a, b, scale)

            def plain():
                a, b = next(pairs)
                return instance_norm_bwd_reference(a, b, scale)

            ms = device_ms(kernel, KERNEL_REPS)
            one = call_ms(kernel, KERNEL_REPS)
            plain_ms = device_ms(plain, KERNEL_REPS)
            # F.instance_norm's autograd backward, one kept graph per copy
            graphs = []
            for _ in range(copies):
                a, b = next(pairs)
                leaves = [a.detach().requires_grad_(),
                          scale.detach().requires_grad_(),
                          bias.detach().requires_grad_()]
                y = F.instance_norm(leaves[0], weight=leaves[1],
                                    bias=leaves[2], eps=1e-5)
                graphs.append((y, leaves, b))
            lib_graphs = itertools.cycle(graphs)

            def library():
                y, leaves, b = next(lib_graphs)
                return torch.autograd.grad(y, leaves, b, retain_graph=True)

            lib = device_ms(library, KERNEL_REPS)
            del graphs, lib_graphs, pairs
            moved = 3 * x.numel() * x.element_size() + 3 * c * 4
            ops = x.numel() * K2_BWD_OPS_PER_ELEM
            b_ms, b_by = bound_ms(moved, ops)
            emit(phase="k2_bwd", shape=list(x.shape), dtype=str(dtype),
                 max_abs_err=err, sums_max_rel_err=sum_err, ms=ms,
                 call_ms=one, plain_ms=plain_ms, library_ms=lib,
                 bound_ms=b_ms, bound_by=b_by)
            tot = totals["f32" if dtype == torch.float32 else "bf16"]
            tot["worst"] = max(tot["worst"], err)
            # 10 launches of this shape per train step
            for key, v in (("ms", ms), ("call_ms", one),
                           ("plain_ms", plain_ms), ("library_ms", lib),
                           ("bytes", moved), ("ops", ops)):
                tot[key] += 10 * v
    return _kernel_rows("instance_norm_bwd",
                        "scflow_tpu/ops/fused_norm.py:148 (_bwd, plain XLA)",
                        totals)


def profile_kernels(fn, top: int = 12) -> dict:
    """One call of ``fn`` under torch.profiler (outside any counted run):
    the sum of its kernels' self device time, their launches, and the
    ``top`` kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    ranked = sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)
    return dict(
        profiled_kernel_ms=sum(e.self_device_time_total for e in kernels) / 1e3,
        profiled_kernel_launches=sum(e.count for e in kernels),
        top_kernels=[{"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                      "calls": e.count} for e in ranked[:top]])


def flat_grads(model) -> "torch.Tensor":
    import torch

    return torch.cat([p.grad.detach().float().cpu().ravel()
                      for p in model.parameters()])


def train_parity(cfg, renderer, points, batch) -> dict:
    """2 samples: one ``scflow_loss`` + backward on the card and on the
    CPU from the same seed-0 weights and the same rendered inputs. Loss
    terms within rtol 1e-4; the whole gradient within max(1e-3, 5 × the
    CPU gradient's own spread under a 1e-6 relative change of the rendered
    images) of the CPU's, as the CPU tests hold the port to JAX (train-mode
    BN at batch 2 makes this f32 gradient ill-conditioned)."""
    import torch

    from scflow_torch.training import build_model, render_at_pose, scflow_loss

    small = {k: v[:2] for k, v in batch.items()}
    with torch.no_grad():
        images, depth, mask = render_at_pose(
            renderer, small["ref_rotations"], small["ref_translations"],
            small["k"], small["labels"], cfg.data.normalize_mean,
            cfg.data.normalize_std)
    full = dict(small, rendered_images=images, rendered_depths=depth,
                rendered_masks=mask)
    runs = []
    for dev, scale in (("cuda", 1.0), ("cpu", 1.0), ("cpu", 1.0 + 1e-6)):
        model = build_model(cfg, device=dev, seed=0)
        points_dev = points.to(dev)
        inp = {k: v.to(dev) for k, v in full.items()}
        inp["rendered_images"] = inp["rendered_images"] * scale
        t0 = time.perf_counter()
        loss, metrics, _ = scflow_loss(model, inp, points_dev, cfg, train=True)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
        runs.append(({k: v.detach().cpu() for k, v in metrics.items()},
                     flat_grads(model), time.perf_counter() - t0))
    (m_gpu, g_gpu, _), (m_cpu, g_cpu, cpu_s), (_, g_nudged, _) = runs
    loss_err = {}
    for key in ("loss", "loss_pose", "loss_flow", "loss_mask"):
        rel = ((m_gpu[key] - m_cpu[key]).abs() / m_cpu[key].abs()).item()
        loss_err[key] = rel
        check(rel <= 1e-4, f"train parity: {key} rel err {rel}")
    spread = ((g_nudged - g_cpu).norm() / g_cpu.norm()).item()
    grad_err = ((g_gpu - g_cpu).norm() / g_cpu.norm()).item()
    check(grad_err <= max(1e-3, 5 * spread),
          f"train parity: gradient rel err {grad_err} (CPU spread {spread})")
    return dict(samples=2, loss_rel_err=loss_err, loss_rtol=1e-4,
                grad_rel_err=grad_err, cpu_grad_spread=spread,
                grad_bound=max(1e-3, 5 * spread), cpu_seconds=cpu_s)


def phase_train(bank) -> tuple:
    """The f32 train step: :func:`drive_train`, then the card against the
    CPU on 2 samples and one 2-cycle step. Returns the run's launches of
    K1, the K2 forward and backward."""
    import torch

    from scflow_torch.training import (Config, DataConfig, ModelConfig,
                                       RenderConfig, build_points_bank,
                                       make_multi_cycle_train_step)

    cfg = Config(model=ModelConfig(num_class=NUM_CLASS, iters=ITERS,
                                   test_iters=ITERS),
                 render=RenderConfig(image_size=SIZE),
                 data=DataConfig(batch_size=TRAIN_BATCH))
    # the icospheres (even labels) are symmetric: the symmetric matching runs
    points = build_points_bank(bank, symmetric_classes=range(0, NUM_CLASS, 2),
                               num_points=cfg.loss.num_loss_points)
    out, run = drive_train("train", cfg, bank, points, TRAIN_WARMUP,
                           TRAIN_STEPS)
    parity = train_parity(cfg, run["renderer"], points, run["batch"])

    multi = make_multi_cycle_train_step(run["model"], run["renderer"], points,
                                        cfg, run["optimizer"], cycles=2,
                                        device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    mc = multi(run["batch"])
    torch.cuda.synchronize()
    mc_s = time.perf_counter() - t0
    mc_counts = counts()
    check(mc_counts == (2, 60, 60),
          f"train: 2-cycle launches K1/K2 fwd/K2 bwd {mc_counts}")
    for key, v in mc.items():
        check(bool(torch.isfinite(v).all()), f"train 2-cycle: {key} not finite")

    launches = out.pop("launches")
    emit(phase="train", classes=NUM_CLASS, lowres=False, **out,
         cpu_parity=parity,
         two_cycle={"ms": 1e3 * mc_s, "launches": list(mc_counts),
                    "cycle0_loss": mc["cycle0_loss"].item(),
                    "cycle1_loss": mc["cycle1_loss"].item()})
    return launches, out["step_ms_median"]


class Timed:
    """Wraps functions so each call is timed between two device syncs,
    with its launches of K1, the K2 forward and backward:
    ``records[name]`` is a list of (start, end, launches)."""

    def __init__(self):
        self.records: dict[str, list] = {}

    def __call__(self, name: str, fn):
        import torch

        def timed(*args, **kw):
            torch.cuda.synchronize()
            before, t0 = counts(), time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.records.setdefault(name, []).append((
                t0, time.perf_counter(),
                tuple(a - b for a, b in zip(counts(), before))))
            return out
        return timed

    def ms(self, name: str) -> list:
        return [1e3 * (t1 - t0) for t0, t1, _ in self.records[name]]


def read_tb_records(path: str) -> int:
    """The number of TFRecords in a TensorBoard event file, each length
    and payload checked against its masked CRC32C."""
    import struct

    from scflow_torch.utils.tb_writer import _masked_crc

    n = 0
    with open(path, "rb") as f:
        while header := f.read(8):
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            check(hcrc == _masked_crc(header) and dcrc == _masked_crc(data),
                  f"trainer: bad TB record crc in {path}")
            n += 1
    return n


def check_fit_outputs(work: str, image_width: int) -> dict:
    """The work dir of the fit: JSONL lines parse and hold the eval and
    EPE records, the checkpoint steps are [TRAINER_STEPS], each panel PNG
    has the PNG signature and the panel's IHDR size, every TB record's
    CRC holds."""
    import glob
    import os
    import struct

    from scflow_torch.training.checkpoint import list_checkpoint_steps

    with open(os.path.join(work, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    check(any("eval/average/auc" in r for r in log)
          and any(f"epe_iter{ITERS - 1}" in r for r in log),
          "trainer: no eval or EPE record in the log")
    steps = list_checkpoint_steps(os.path.join(work, "checkpoints"))
    check(steps == [TRAINER_STEPS], f"trainer: checkpoint steps {steps}")
    pngs = sorted(glob.glob(os.path.join(work, "images", "*.png")))
    check(len(pngs) == TRAINER_STEPS // TRAINER_EVERY,
          f"trainer: panels {pngs}")
    for path in pngs:
        with open(path, "rb") as f:
            head = f.read(24)
        check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR"
              and struct.unpack(">II", head[16:24]) == (image_width, SIZE[0]),
              f"trainer: bad PNG header {head!r}")
    events = glob.glob(os.path.join(work, "tb", "events.out.tfevents.*"))
    check(len(events) == 2, f"trainer: TB files {events}")
    ckpt = os.path.join(work, "checkpoints", f"step_{TRAINER_STEPS:08d}",
                        "state.pt")
    return dict(log_records=len(log), checkpoint_steps=steps,
                panels=[os.path.basename(p) for p in pngs],
                tb_records=sum(read_tb_records(p) for p in events),
                checkpoint_mb=os.path.getsize(ckpt) / 2 ** 20)


def check_resume(trainer, batch) -> dict:
    """A fresh Trainer's ``resume`` against the live state: every model
    tensor, AdamW moment and the step bit-equal; then one step from each
    on ``batch``: bit-equal loss terms, parameters within Adam's step
    bound (see RESUME_*)."""
    import torch

    from scflow_torch.training import onecycle_lr
    from scflow_torch.training.trainer import Trainer

    t0 = time.perf_counter()
    fresh = Trainer(trainer.cfg, trainer.renderer, trainer.points_bank,
                    device="cuda")
    step = fresh.resume()
    torch.cuda.synchronize()
    resume_ms = 1e3 * (time.perf_counter() - t0)
    check(step == TRAINER_STEPS and fresh.step == trainer.step,
          f"resume: step {step}, updates {fresh.step} vs {trainer.step}")
    live, restored = trainer.model.state_dict(), fresh.model.state_dict()
    for k, v in live.items():
        check(torch.equal(v, restored[k]), f"resume: {k} differs")
    opt_live = trainer.optimizer.state_dict()["state"]
    opt_restored = fresh.optimizer.state_dict()["state"]
    check(opt_live.keys() == opt_restored.keys(), "resume: AdamW state keys")
    for i, s in opt_live.items():
        for k, v in s.items():
            check(torch.equal(v, opt_restored[i][k]),
                  f"resume: AdamW {i}/{k} differs")
    before = [p.detach().clone() for p in trainer.model.parameters()]
    lr = onecycle_lr(trainer.step, trainer.cfg.optim)
    m_live = trainer.train_step(batch)
    m_restored = fresh.train_step(batch)
    for key in ("loss", "loss_pose", "loss_flow", "loss_mask"):
        check(torch.equal(m_live[key], m_restored[key]),
              f"resume: {key} {m_live[key].item()} vs "
              f"{m_restored[key].item()}")
    diff = torch.cat([(a.detach() - b.detach()).ravel() for a, b in zip(
        trainer.model.parameters(), fresh.model.parameters())])
    update = torch.cat([(a.detach() - b).ravel() for a, b in zip(
        trainer.model.parameters(), before)])
    max_diff = diff.abs().max().item()
    rel = (diff.norm() / update.norm()).item()
    check(max_diff <= RESUME_LR_MULT * lr and rel <= RESUME_UPDATE_RTOL,
          f"resume: parameters {max_diff} (lr {lr}), {rel} of the update")
    grad_gap = abs(m_live["grad_norm"].item() - m_restored["grad_norm"].item())
    del fresh
    return dict(resume_ms=resume_ms, tensors=len(live),
                adamw_tensors=sum(len(s) for s in opt_live.values()),
                next_step={"loss_bit_equal": True,
                           "param_max_abs_diff": max_diff, "lr": lr,
                           "bound_abs": RESUME_LR_MULT * lr,
                           "param_diff_over_update": rel,
                           "bound_rel": RESUME_UPDATE_RTOL,
                           "grad_norm_gap": grad_gap})


def check_trainer_eval(trainer, batch) -> dict:
    """``evaluate_device_accumulator`` on the card and on the port's CPU
    path (a CPU Trainer with the card's weights) over the same 2 samples:
    per-sample ADD(-S) errors within EVAL_ERR_RTOL; equal metrics unless
    an error lies within that distance of a threshold or a bin edge."""
    import torch

    from scflow_torch.rendering import Renderer, make_test_meshes
    from scflow_torch.training import build_points_bank
    from scflow_torch.training.evaluate import (evaluate_device_accumulator,
                                                pose_errors)
    from scflow_torch.training.trainer import Trainer

    cfg = trainer.cfg
    small = {k: v[:2] for k, v in batch.items()}
    bank = make_test_meshes(NUM_CLASS, subdivisions=2, device="cpu")
    cpu = Trainer(cfg, Renderer(bank, image_size=SIZE),
                  build_points_bank(bank, num_points=cfg.loss.num_loss_points),
                  device="cpu")
    cpu.model.load_state_dict(trainer.model.state_dict())
    cpu_small = {k: v.cpu() for k, v in small.items()}
    t0 = time.perf_counter()
    got = evaluate_device_accumulator(trainer, [small], trainer.points_bank,
                                      NUM_CLASS)
    card_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    want = evaluate_device_accumulator(cpu, [cpu_small], cpu.points_bank,
                                       NUM_CLASS)
    cpu_s = time.perf_counter() - t0
    errs = []
    for tr, b in ((trainer, small), (cpu, cpu_small)):
        out = tr.predict(b, sync=False)
        errs.append(pose_errors(out["rotations"], out["translations"],
                                b["gt_rotations"], b["gt_translations"],
                                b["labels"], tr.points_bank).cpu())
    err_card, err_cpu = errs
    rel = ((err_card - err_cpu).abs() / err_cpu.abs()).max().item()
    check(rel <= EVAL_ERR_RTOL, f"eval: ADD(-S) errors {err_card.tolist()} "
          f"vs CPU {err_cpu.tolist()}")
    if got != want:
        # an error within EVAL_ERR_RTOL of a histogram bin edge (whole mm:
        # 100 bins over 100 mm) or of a threshold (0.05, 0.1, 0.2, 0.5 of
        # the diameter: whole hundredths) may count on the other side
        diam = cpu.points_bank.diameters[cpu_small["labels"].long()]
        scaled = [*err_cpu.tolist(), *(100 * err_cpu / diam).tolist()]
        check(any(abs(x - round(x)) <= EVAL_ERR_RTOL * abs(x)
                  for x in scaled), f"eval: card {got} vs CPU {want}")
    return dict(samples=2, card=got, cpu_equal=got == want,
                add_errors_mm=err_card.tolist(),
                cpu_add_errors_mm=err_cpu.tolist(), max_rel_err=rel,
                rtol=EVAL_ERR_RTOL, card_ms=card_ms, cpu_seconds=cpu_s)


def phase_trainer(train_ms: float) -> tuple:
    """The training CLI on the card; returns its launches of K1, the K2
    forward and backward. ``train_ms``: the train phase's median step."""
    import tempfile
    from unittest import mock

    import numpy as np
    import torch

    import scflow_torch.train as cli
    import scflow_torch.training.logging as logging_mod
    import scflow_torch.training.trainer as trainer_mod
    from scflow_torch.data import synthetic_batch
    from scflow_torch.training import make_eval_step

    t_phase = time.perf_counter()
    timed = Timed()

    def timed_factory(tag, factory):
        return lambda *args, **kw: timed(tag, factory(*args, **kw))

    # the steps the Trainer builds, and the functions fit and the CLI call
    patches = [mock.patch.object(trainer_mod, name, timed_factory(
        tag, getattr(trainer_mod, name))) for name, tag in (
            ("make_train_step", "train"), ("make_panel_step", "panel"))]
    patches += [mock.patch.object(mod, name, timed(tag, getattr(mod, name)))
                for mod, name, tag in (
                    (cli, "evaluate_device_accumulator", "eval"),
                    (trainer_mod, "save_checkpoint", "save"),
                    (logging_mod.ImageLogger, "log_panel", "log_panel"))]
    with tempfile.TemporaryDirectory(prefix="scflow_trainer_") as work:
        argv = ["--synthetic", "--work-dir", work, "--device", "cuda",
                "--steps", str(TRAINER_STEPS), "--batch-size",
                str(TRAIN_BATCH), "--image-size", str(SIZE[0]),
                "--num-classes", str(NUM_CLASS), "--iters", str(ITERS),
                "--eval-every", str(TRAINER_EVERY),
                "--panel-every", str(TRAINER_EVERY)]
        for p in patches:
            p.start()
        try:
            reset_counts()
            t0 = time.perf_counter()
            trainer = cli.main(argv)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            launches = counts()
        finally:
            for p in patches:
                p.stop()
        outputs = check_fit_outputs(work, 6 * SIZE[1])
        check(trainer.step == TRAINER_STEPS, f"trainer: {trainer.step} steps")
        steps = timed.records["train"]
        for _, _, n in steps:
            check(n == (1, 30, 30), f"trainer: launches per train step {n}")
        starts = [t0 for t0, _, _ in steps]
        fit_step_ms = [1e3 * (b - a) for a, b in zip(starts, starts[1:])]
        eval_batch = synthetic_batch(torch.Generator().manual_seed(7_777),
                                     trainer.renderer, TRAIN_BATCH)
        resume = check_resume(trainer, eval_batch)
        evaluation = check_trainer_eval(trainer, eval_batch)
        bare = make_eval_step(trainer.model, trainer.renderer, trainer.cfg,
                              device="cuda")(eval_batch)
        pred = trainer.predict(eval_batch)
        for key in ("rotations", "translations"):
            check(np.array_equal(pred[key], bare[key].cpu().numpy()),
                  f"trainer: predict {key} differs from the eval step")
    emit(phase="trainer", batch=TRAIN_BATCH, image=list(SIZE),
         classes=NUM_CLASS, iters=ITERS, dtype="float32",
         steps=TRAINER_STEPS, eval_every=TRAINER_EVERY,
         fit_step_ms_median=statistics.median(fit_step_ms),
         fit_step_ms=fit_step_ms, train_phase_step_ms_median=train_ms,
         train_step_in_fit_ms=timed.ms("train")[:TRAINER_STEPS],
         eval_ms=timed.ms("eval"), panel_step_ms=timed.ms("panel"),
         panel_write_ms=timed.ms("log_panel"), save_ms=timed.ms("save"),
         fit_seconds=fit_s,
         launches_per_train_step=dict(zip(
             ("rasterize_tiles", "instance_norm_fwd", "instance_norm_bwd"),
             steps[0][2])),
         launches=list(launches),
         launches_per_eval=[list(n) for _, _, n in timed.records["eval"]],
         launches_per_panel=[list(n) for _, _, n in timed.records["panel"]],
         **outputs, resume=resume, eval_parity=evaluation,
         predict_equals_eval_step=True,
         phase_seconds=time.perf_counter() - t_phase)
    return launches


def norm_input_dtypes(model) -> tuple[list, list]:
    """Forward pre-hooks on every instance norm of ``model`` that record
    the type of the tensor each call hands to K2: (records, handles)."""
    from scflow_torch.models.layers import FusedInstanceNorm

    seen = []
    handles = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].dtype))
        for m in model.modules() if isinstance(m, FusedInstanceNorm)]
    return seen, handles


def pose_gap(a: dict, b: dict) -> dict:
    """Largest rotation-entry and translation differences of two outputs."""
    return {key: (a[key].cpu() - b[key].cpu()).abs().max().item()
            for key in ("rotations", "translations")}


def phase_bf16(renderer, batch, cpu_f32, gpu_f32) -> tuple:
    """The eval step in bf16 at the main path's shapes; returns the run's
    K1 and K2 launches. ``cpu_f32``/``gpu_f32``: the f32 outputs of the main
    path's 2 CPU samples and of the card."""
    import torch

    from scflow_torch.rendering import Renderer, make_test_meshes
    from scflow_torch.training import (Config, ModelConfig, RenderConfig,
                                       build_model, make_eval_step)

    cfg = Config(model=ModelConfig(num_class=NUM_CLASS, iters=ITERS,
                                   test_iters=ITERS, dtype="bfloat16"),
                 render=RenderConfig(image_size=SIZE))
    model = build_model(cfg, device="cuda", seed=0)
    step = make_eval_step(model, renderer, cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    run_path("bf16_warmup", step, batch, WARMUP, renders=1)
    seen, handles = norm_input_dtypes(model)
    run = run_path("bf16", step, batch, STEPS, renders=1)
    for h in handles:
        h.remove()
    check(len(seen) == 30 * STEPS and set(seen) == {torch.bfloat16},
          f"bf16: K2 inputs {len(seen)} of types {set(seen)}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = 1e3 * statistics.median(run["times"])
    kernels = profile_kernels(lambda: step(batch))

    cpu_model = build_model(cfg, device="cpu", seed=0)
    cpu_renderer = Renderer(make_test_meshes(NUM_CLASS, subdivisions=3,
                                             radius=60.0, device="cpu"),
                            image_size=SIZE)
    t0 = time.perf_counter()
    cpu_bf16 = make_eval_step(cpu_model, cpu_renderer, cfg, device="cpu")(
        {k: v[:2].cpu() for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    gpu_bf16 = {k: v[:2] for k, v in run["out"].items()}
    gpu_f32 = {k: v[:2] for k, v in gpu_f32.items()}
    err = pose_gap(gpu_bf16, cpu_bf16)
    gap = pose_gap(cpu_bf16, cpu_f32)
    for key in err:
        check(err[key] <= BF16_GAP_MULT * gap[key],
              f"bf16 parity: {key} err {err[key]} > {BF16_GAP_MULT} × the "
              f"CPU's bf16-vs-f32 gap {gap[key]}")
    emit(phase="bf16", batch=BATCH, image=list(SIZE), classes=NUM_CLASS,
         iters=ITERS, lowres=True, dtype="bfloat16", steps=STEPS,
         step_ms_median=step_ms, step_ms_min=1e3 * min(run["times"]),
         step_ms=[1e3 * t for t in run["times"]],
         frames_per_s=BATCH / (step_ms / 1e3), peak_mem_gib=peak,
         launches_per_step={"rasterize_tiles": run["k1"] // STEPS,
                            "instance_norm_fwd": run["k2"] // STEPS},
         k2_input_dtypes=sorted(str(d) for d in set(seen)), **kernels,
         cpu_parity={"samples": 2, "card_bf16_vs_cpu_bf16": err,
                     "cpu_bf16_vs_cpu_f32": gap,
                     "card_bf16_vs_card_f32": pose_gap(gpu_bf16, gpu_f32),
                     "bound": f"{BF16_GAP_MULT} x cpu_bf16_vs_cpu_f32",
                     "cpu_seconds": cpu_s})
    return run["k1"], run["k2"]


def drive_train(name: str, cfg, bank, points, warmup: int, steps: int,
                dtype_check=None) -> tuple[dict, dict]:
    """Train ``steps`` steps after ``warmup`` on one synthetic batch (seed 0)
    with the counts at 0 just before; check launches per step (K1 1, K2
    forward and backward 30 each), finite metrics, a gradient, moved
    parameters and BN statistics, and (``dtype_check``) the one type of
    every K2 input; profile one more step. Returns (the line's fields,
    the run: model, optimizer, renderer, batch)."""
    import torch

    from scflow_torch.data import synthetic_batch
    from scflow_torch.rendering import Renderer
    from scflow_torch.training import build_model, make_optimizer, make_train_step

    renderer = Renderer(bank, image_size=SIZE)
    batch = synthetic_batch(torch.Generator().manual_seed(0), renderer,
                            cfg.data.batch_size)
    check(bool((batch["gt_masks"].sum((1, 2)) > 0).all()),
          f"{name}: an object is not visible")
    model = build_model(cfg, device="cuda", seed=0)
    opt = make_optimizer(cfg, model.parameters())
    step = make_train_step(model, renderer, points, cfg, opt, device="cuda")

    def bn_stats():
        return [b.detach().clone() for n, b in model.named_buffers()
                if n.endswith(("running_mean", "running_var"))]

    params0 = [p.detach().clone() for p in model.parameters()]
    stats0 = bn_stats()
    for _ in range(warmup):
        step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seen, handles = norm_input_dtypes(model)
    reset_counts()
    times, losses = [], []
    metrics = None
    for _ in range(steps):
        t0 = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for h in handles:
        h.remove()
    want = (steps, 30 * steps, 30 * steps)
    check(launches == want, f"{name}: launches K1/K2 fwd/K2 bwd {launches}, "
          f"want {want}")
    if dtype_check is not None:
        check(set(seen) == {dtype_check},
              f"{name}: K2 inputs of types {set(seen)}")
    for key, v in metrics.items():
        check(bool(torch.isfinite(v).all()), f"{name}: {key} not finite")
    check(metrics["loss"].item() > 0 and metrics["grad_norm"].item() > 0,
          f"{name}: zero loss or gradient")
    moved = max((p.detach() - p0).abs().max().item()
                for p, p0 in zip(model.parameters(), params0))
    check(moved > 0, f"{name}: the parameters did not move")
    stats_moved = max((a - b).abs().max().item()
                      for a, b in zip(bn_stats(), stats0))
    check(stats_moved > 0, f"{name}: the BN running statistics did not move")
    step_ms = 1e3 * statistics.median(times)
    out = dict(batch=cfg.data.batch_size, image=list(SIZE),
               iters=cfg.model.iters, dtype=cfg.model.dtype, steps=steps,
               step_ms_median=step_ms, step_ms_min=1e3 * min(times),
               step_ms_max=1e3 * max(times), step_ms=[1e3 * t for t in times],
               samples_per_s=cfg.data.batch_size / (step_ms / 1e3),
               peak_mem_gib=peak, losses=losses,
               grad_norm=metrics["grad_norm"].item(),
               param_max_change=moved, bn_stats_max_change=stats_moved,
               launches=launches,
               launches_per_step={"rasterize_tiles": launches[0] // steps,
                                  "instance_norm_fwd": launches[1] // steps,
                                  "instance_norm_bwd": launches[2] // steps},
               k2_input_dtypes=sorted(str(d) for d in set(seen)),
               **profile_kernels(lambda: step(batch)))
    return out, dict(model=model, optimizer=opt, renderer=renderer,
                     batch=batch)


def phase_train_bf16(bank) -> tuple:
    """The train step in bf16 at the train phase's shapes; returns the
    run's launches of K1, the K2 forward and backward."""
    import torch

    from scflow_torch.training import (Config, DataConfig, ModelConfig,
                                       RenderConfig, build_points_bank)

    cfg = Config(model=ModelConfig(num_class=NUM_CLASS, iters=ITERS,
                                   test_iters=ITERS, dtype="bfloat16"),
                 render=RenderConfig(image_size=SIZE),
                 data=DataConfig(batch_size=TRAIN_BATCH))
    points = build_points_bank(bank, symmetric_classes=range(0, NUM_CLASS, 2),
                               num_points=cfg.loss.num_loss_points)
    out, _ = drive_train("train_bf16", cfg, bank, points, TRAIN_WARMUP,
                         BF16_TRAIN_STEPS, dtype_check=torch.bfloat16)
    launches = out.pop("launches")
    emit(phase="train_bf16", lowres=False, **out)
    return launches


def raft_config(**data):
    """The ``raft_ycbv`` recipe at full width: RAFT flow + occlusion, Basic
    encoders (shared), 4 levels, radius 4, 12 iterations; flow and mask
    losses of weight 1, no pose loss."""
    from scflow_torch.training import (Config, DataConfig, LossConfig,
                                       ModelConfig, RenderConfig)

    return Config(model=ModelConfig(family="raft_flow_mask", num_class=NUM_CLASS,
                                    iters=RAFT_ITERS, test_iters=RAFT_ITERS),
                  loss=LossConfig(pose_weight=0.0, flow_weight=1.0,
                                  mask_weight=1.0),
                  render=RenderConfig(image_size=SIZE),
                  data=DataConfig(**data))


def pnp_known_flow(renderer, batch) -> dict:
    """PnP on the exact flow from the reference to the GT pose of the
    batch's render, at batch 32, with the same injected draws on the card
    and the CPU: every sample must recover the GT pose within 0.5° and
    5 mm (tests/test_flow_pose.py's bounds)."""
    import torch

    from scflow_torch.geometry import flow_from_pose_and_depth
    from scflow_torch.models.flow_pose import (gumbel_draws,
                                               solve_pose_from_flow_core)

    with torch.inference_mode():
        depth = renderer(batch["ref_rotations"], batch["ref_translations"],
                         batch["k"], batch["labels"].long())["depth"]
        flow = flow_from_pose_and_depth(
            batch["ref_rotations"], batch["ref_translations"],
            batch["gt_rotations"], batch["gt_translations"], depth,
            batch["k"])
        n, h, w = depth.shape
        draws = gumbel_draws(torch.Generator().manual_seed(1), n, h * w)
        args = (flow, None, depth, batch["ref_rotations"],
                batch["ref_translations"], batch["k"])
        gt_r, gt_t = (batch[k].cpu() for k in ("gt_rotations",
                                                "gt_translations"))
        summary, results = {}, []
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            res = solve_pose_from_flow_core(
                *(d.to(dev) for d in draws),
                *(None if a is None else a.to(dev) for a in args))
            if dev == "cuda":
                torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            # angle from ‖R − R_gt‖_F = 2√2·sin(θ/2) (acos of the trace
            # cannot resolve f32 angles below ~0.02°)
            fro = (res["rotations"].cpu().double() - gt_r.double()).flatten(1)
            ang = torch.rad2deg(2 * torch.asin(
                (fro.norm(dim=-1) / (2 * math.sqrt(2))).clamp(max=1.0)))
            dt = (res["translations"].cpu() - gt_t).norm(dim=-1)
            check(bool(res["valid"].all()), f"pnp {dev}: a sample fell back")
            check(ang.max().item() < 0.5 and dt.max().item() < 5.0,
                  f"pnp {dev}: {ang.max().item()} deg, {dt.max().item()} mm")
            summary[dev] = dict(max_deg=ang.max().item(),
                                max_mm=dt.max().item(), seconds=sec)
            results.append(res)
    summary["card_vs_cpu"] = pose_gap(*results)
    return summary


def phase_raft(renderer, batch) -> tuple:
    """The RAFT eval step (flow → RANSAC-EPnP) at the raft_ycbv width and
    the main path's batch; returns the run's K1 and K2 launches."""
    import torch

    from scflow_torch.models.flow_pose import solve_pose_from_flow
    from scflow_torch.training import (build_model, device_normalize_images,
                                       make_eval_step, render_at_pose)

    cfg = raft_config()
    model = build_model(cfg, device="cuda", seed=0)
    step = make_eval_step(model, renderer, cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    run_path("raft_warmup", step, batch, WARMUP, renders=1, moves=False)
    run = run_path("raft", step, batch, RAFT_STEPS, renders=1, moves=False)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = 1e3 * statistics.median(run["times"])
    valid = run["out"]["pnp_valid"]
    kernels = profile_kernels(lambda: step(batch))

    # the two stages alone, one call each (host time included)
    with torch.inference_mode():
        rendered, depth, _ = render_at_pose(
            renderer, batch["ref_rotations"], batch["ref_translations"],
            batch["k"], batch["labels"].long(), cfg.data.normalize_mean,
            cfg.data.normalize_std)
        real = device_normalize_images(batch["real_images"], cfg)
        flows, masks = model(rendered, real, iters=cfg.model.test_iters)
        net_ms = call_ms(lambda: model(rendered, real,
                                       iters=cfg.model.test_iters), 3, 1)
        pnp_ms = call_ms(lambda: solve_pose_from_flow(
            torch.Generator(device="cuda").manual_seed(0), flows[-1],
            masks[-1][..., 0], depth, batch["ref_rotations"],
            batch["ref_translations"], batch["k"]), 3, 1)

    # the network's flows and occlusions of 2 samples against the CPU, on
    # the card's rendered and real images
    cpu_model = build_model(cfg, device="cpu", seed=0)
    t0 = time.perf_counter()
    with torch.inference_mode():
        cpu_flows, cpu_masks = cpu_model(rendered[:2].cpu(), real[:2].cpu(),
                                         iters=cfg.model.test_iters)
    cpu_s = time.perf_counter() - t0
    errs = {}
    for key, got, want, tol in (
            ("flow", flows[-1, :2], cpu_flows[-1], RAFT_FLOW_TOL),
            ("masks", masks[-1, :2], cpu_masks[-1], RAFT_OCC_TOL)):
        diff = (got.cpu() - want).abs()
        errs[key] = diff.max().item()
        check(bool((diff <= tol["atol"] + tol["rtol"] * want.abs()).all()),
              f"raft cpu parity: {key} err {errs[key]}")
    del flows, masks, cpu_flows, cpu_masks
    pnp = pnp_known_flow(renderer, batch)
    emit(phase="raft", family="raft_flow_mask", batch=BATCH, image=list(SIZE),
         iters=RAFT_ITERS, dtype="float32", steps=RAFT_STEPS,
         step_ms_median=step_ms, step_ms_min=1e3 * min(run["times"]),
         step_ms=[1e3 * t for t in run["times"]],
         frames_per_s=BATCH / (step_ms / 1e3), peak_mem_gib=peak,
         network_ms=net_ms, pnp_ms=pnp_ms,
         pnp_valid_share=valid.float().mean().item(), **kernels,
         launches_per_step={"rasterize_tiles": run["k1"] // RAFT_STEPS,
                            "instance_norm_fwd": run["k2"] // RAFT_STEPS},
         cpu_parity={"samples": 2, "max_abs_err": errs,
                     "flow_tol": RAFT_FLOW_TOL, "occlusion_tol": RAFT_OCC_TOL,
                     "cpu_seconds": cpu_s},
         pnp_known_flow=pnp)
    return run["k1"], run["k2"]


def phase_raft_train(bank) -> tuple:
    """The RAFT train step (raft_loss) at the train batch, 12 iterations;
    returns the run's launches of K1, the K2 forward and backward."""
    from scflow_torch.training import build_points_bank

    cfg = raft_config(batch_size=TRAIN_BATCH)
    points = build_points_bank(bank, num_points=cfg.loss.num_loss_points)
    out, _ = drive_train("raft_train", cfg, bank, points, TRAIN_WARMUP,
                         RAFT_TRAIN_STEPS)
    launches = out.pop("launches")
    emit(phase="raft_train", family="raft_flow_mask", **out)
    return launches


def frame_poses(n: int, seed: int, size: tuple) -> tuple:
    """``n`` objects anywhere in a ``size`` frame seen by YCB-V's camera,
    700–1200 mm away: (rotations, translations, k, labels) on the CPU."""
    import torch

    from scflow_torch.geometry import quaternion_to_matrix

    g = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, NUM_CLASS, (n,), generator=g)
    rot = quaternion_to_matrix(torch.randn(n, 4, generator=g))
    h, w = size
    k = torch.tensor(YCBV_K).expand(n, 3, 3).contiguous()
    z = torch.rand(n, generator=g) * 500 + 700
    u = torch.rand(n, generator=g) * (w - 160) + 80
    v = torch.rand(n, generator=g) * (h - 160) + 80
    t = torch.stack([(u - k[:, 0, 2]) * z / k[:, 0, 0],
                     (v - k[:, 1, 2]) * z / k[:, 1, 1], z], dim=-1)
    return rot, t, k, labels


def k1_bare(bank, poses: tuple, size: tuple) -> dict:
    """K1's no-attribute form against its plain version on the faces of
    ``poses`` at ``size``: face ids and z bit for bit; device and call
    time, the plain version's, and the bound (each face's 14 coefficients
    read once, 8 bytes written per pixel; 22 operations per filled
    (pixel, slot) pair)."""
    import torch

    from scflow_torch.ops import rasterize_fast as rf
    from scflow_torch.rendering import Renderer

    h, w = size
    renderer = Renderer(bank, image_size=size, render_image=False)
    inp = renderer.rasterizer_inputs(*(x.cuda() for x in poses))
    coeff, bbox, attr, d, k = rf.tile_inputs(
        inp["tri_xy"], inp["tri_z"], inp["face_valid"], h, w, None)
    check(attr is None and d == 0, "k1_bare: tile_inputs made attributes")
    args = (coeff, bbox, None, h, w, 0, k)
    got = rf.rasterize_tiles(*args)
    want = rf.rasterize_tiles_reference(*args)
    torch.cuda.synchronize()
    bits = {name: torch.equal(a.view(torch.int32), b.view(torch.int32))
            for name, a, b in zip(("face_id", "zbuf"), got, want)}
    check(bool((want[0] >= 0).any()), "k1_bare: nothing rendered")
    check(all(bits.values()) and got[2].numel() == 0,
          f"k1_bare {size}: not bit-equal to the plain version {bits}")
    err = (got[1] - want[1]).abs().max().item()
    ms = device_ms(lambda: rf.rasterize_tiles(*args), KERNEL_REPS)
    one = call_ms(lambda: rf.rasterize_tiles(*args), KERNEL_REPS)
    plain = call_ms(lambda: rf.rasterize_tiles_reference(*args), 3, 1)
    sel = rf._select_tiles(bbox.unbind(-1), coeff[..., 14] > 0, h, w, k)
    pairs = (sel >= 0).sum().item() * rf.TILE * rf.TILE
    faces = coeff.shape[0] * coeff.shape[1]
    moved = faces * K1_COEFF_USED * 4 + sum(x.numel() * 4 for x in got[:2])
    b_ms, b_by = bound_ms(moved, pairs * K1_OPS_PER_PAIR)
    return dict(batch=coeff.shape[0], frame=list(size), faces=coeff.shape[1],
                k=k, covered_share=(want[0] >= 0).float().mean().item(),
                pixel_face_pairs=pairs, bit_equal=bits, max_abs_err=err,
                ms=ms, call_ms=one, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, bytes=moved)


def depth_rounding_scale(coeff, face_id):
    """Per pixel, the f32 rounding scale s = u·Σₖ |ztₖ|(|aₖx| + |bₖy| +
    |cₖ|) of evaluating the winning face's coefficient row (N, F, 16) at
    the pixel, u = 2⁻²⁴ (``float64_witness`` of the CPU render tests): the
    edge functions cancel terms far larger than the depth they give."""
    import torch

    n, h, w = face_id.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, device=coeff.device, dtype=torch.float64),
        torch.arange(w, device=coeff.device, dtype=torch.float64),
        indexing="ij")
    rows = torch.arange(n, device=coeff.device)[:, None, None]
    row = coeff.double()[rows, face_id.clamp_min(0).long()]
    scale = 0.0
    for k in range(3):
        a, b, c, zt = (row[..., 3 * k], row[..., 3 * k + 1],
                       row[..., 3 * k + 2], row[..., 9 + k])
        scale = scale + ((a * xs).abs() + (b * ys).abs() + c.abs()) * zt.abs()
    return 2.0 ** -24 * scale


def silhouette_path(bank, cpu_bank, poses: tuple, size: tuple,
                    renders: int) -> dict:
    """``Renderer(render_image=False, render_mask=True,
    soft_blending=True)`` ``renders`` times with the counts at 0 just
    before: one launch of K1's no-attribute form and nothing else per
    render, no ``images``; the first 2 samples against the CPU (masks
    exact, depth within 1e-3 + 2·s of ``depth_rounding_scale``, the CPU
    render tests' bound; soft alpha within SIL_TOL)."""
    import torch

    from scflow_torch.ops import rasterize_fast as rf
    from scflow_torch.ops.rasterize_fast import rasterize_tiles
    from scflow_torch.rendering import Renderer

    opts = dict(image_size=size, render_image=False, render_mask=True,
                soft_blending=True)
    renderer = Renderer(bank, **opts)
    args = tuple(x.cuda() for x in poses)
    with torch.inference_mode():
        reset_counts()
        times = []
        for _ in range(renders):
            t0 = time.perf_counter()
            out = renderer(*args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = (*counts(), rasterize_tiles.bare_launches)
        check(launches == (renders, 0, 0, renders),
              f"silhouette {size}: launches K1/K2/K2 bwd/K1 bare {launches}")
        check(set(out) == {"depth", "mask", "masks"},
              f"silhouette: outputs {sorted(out)}")
        alpha = out["masks"]
        check(bool(((alpha >= 0.5) == out["mask"]).all()
                   and (alpha <= 1).all()), "silhouette: alpha outside its range")
        cpu = Renderer(cpu_bank, **opts)(*(x[:2] for x in poses))
        inp = renderer.rasterizer_inputs(*(x[:2] for x in args))
        faces = (inp["tri_xy"], inp["tri_z"], inp["face_valid"])
        face_id = rf.rasterize_fast(*faces, *size,
                                    return_bary=False)["face_id"]
        scale = depth_rounding_scale(rf._coeff_table(*faces)[0], face_id)
    err = {key: (out[key][:2].cpu().float() - cpu[key].float()).abs().max().item()
           for key in ("depth", "masks")}
    check(torch.equal(out["mask"][:2].cpu(), cpu["mask"]),
          f"silhouette {size}: masks differ from the CPU's")
    depth_gap = (out["depth"][:2].cpu() - cpu["depth"]).abs()
    err["depth_over_scale"] = (depth_gap / (1e-3 + 2.0 * scale.cpu())
                               ).max().item()
    check(err["depth_over_scale"] <= 1.0 and err["masks"] <= SIL_TOL,
          f"silhouette {size}: card vs CPU {err}")
    return dict(frame=list(size), batch=args[0].shape[0], renders=renders,
                render_ms=[1e3 * t for t in times],
                covered_share=out["mask"].float().mean().item(),
                launches_per_render={"rasterize_tiles[no_attrs]": 1},
                cpu_max_abs_err=err, launches=launches)


def rasterizers_agree(bank, batch) -> dict:
    """The tile kernel, the binned and the scan pass on the same projected
    faces at the main path's batch: face ids of the tile kernel and the
    binned pass equal, the scan's within JAX's own share of exact-edge
    tie-breaks (RASTER_MISMATCH); one render with each, timed."""
    import torch

    from scflow_torch.ops.rasterize_fast import rasterize_fast
    from scflow_torch.rendering import Renderer
    from scflow_torch.rendering.rasterizer import (project_vertices,
                                                   rasterize, rasterize_binned)

    h, w = SIZE
    args = (batch["ref_rotations"], batch["ref_translations"], batch["k"],
            batch["labels"].long())
    with torch.inference_mode():
        inp = Renderer(bank, image_size=SIZE).rasterizer_inputs(*args)
        valid, faces = inp["face_valid"], inp["faces"]
        xy, z = project_vertices(inp["verts"], *args[:3])
        rows = torch.arange(xy.shape[0], device=xy.device)[:, None, None]
        ids = {"pallas": rasterize_fast(xy[rows, faces], z[rows, faces],
                                        valid, h, w,
                                        return_bary=False)["face_id"],
               "binned": rasterize_binned(xy, z, faces, valid, h, w,
                                          return_bary=False)["face_id"],
               "scan": rasterize(xy, z, faces, valid, h, w)["face_id"]}
        torch.cuda.synchronize()
        render_ms = {kind: call_ms(lambda kind=kind: Renderer(
            bank, image_size=SIZE, rasterizer=kind)(*args), 3, 1)
            for kind in ids}
    differ = {kind: (ids[kind] != ids["pallas"]).float().mean().item()
              for kind in ("binned", "scan")}
    check(bool((ids["pallas"] >= 0).any()) and differ["binned"] == 0.0
          and differ["scan"] <= RASTER_MISMATCH,
          f"rasterizers: face-id mismatch shares {differ}")
    return dict(batch=xy.shape[0], frame=list(SIZE),
                face_id_mismatch_share=differ,
                scan_bound=RASTER_MISMATCH, render_ms=render_ms)


def k2_small() -> dict:
    """The K2 forward at the Small encoder's IN shapes, at the eval batch
    in f32 (the Small paths' type), against its plain version."""
    import torch

    g = torch.Generator().manual_seed(3)
    errs = {}
    for c, side in SMALL_IN_SHAPES:
        x = (torch.randn(BATCH, c, side, side, generator=g) * 2 + 0.5).cuda()
        scale = (1 + 0.3 * torch.randn(c, generator=g)).cuda()
        bias = (0.2 * torch.randn(c, generator=g)).cuda()
        errs[f"{BATCH}x{c}x{side}x{side}"] = k2_fwd_check(x, scale, bias,
                                                          "k2 small")
    return errs


def k2_control(model, rendered, real, cpu_flow, spread: float) -> dict:
    """The RAFT flow bound's control: the card's flow with every IN output
    off by K2_CONTROL_REL of itself (each IN's affine scaled; the model is
    not used again) must fail the bound the real run passed."""
    import torch

    from scflow_torch.models.layers import FusedInstanceNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FusedInstanceNorm):
                m.weight.mul_(1 + K2_CONTROL_REL)
                m.bias.mul_(1 + K2_CONTROL_REL)
    with torch.inference_mode():
        flows, _ = model(rendered, real)
    diff = (flows[-1].cpu() - cpu_flow).abs()
    err = diff.max().item()
    passes = (bool((diff <= RAFT_FLOW_TOL["atol"] + RAFT_FLOW_TOL["rtol"]
                    * cpu_flow.abs()).all()) or err <= 5 * spread)
    check(not passes, f"control: a K2 off by {K2_CONTROL_REL} of its output "
          f"passes the flow bound (err {err}, CPU spread {spread})")
    return dict(k2_output_rel_err=K2_CONTROL_REL, flow_max_abs_err=err)


def options_eval(name: str, model_kw: dict, renderer, cpu_renderer, batch,
                 k2_per_step: int) -> dict:
    """The eval step at the main path's width under ``model_kw``: 1
    warm-up and OPTIONS_STEPS steps with the counts at 0 just before (K1 1,
    K2 ``k2_per_step``); 2 samples against the CPU port: SCFlow poses to
    POSE_TOL; RAFT's network flows and occlusions (its PnP is chaotic on
    random weights, see the raft phase) to the raft phase's bounds, or the
    flow within 5× the CPU's own spread under a 1e-6 relative change of
    the rendered images (the Small net's flow is ~12× as sensitive as the
    Basic net's: 4.4e-3 against 3.5e-4 px after 12 iterations); then
    :func:`k2_control` shows that bound fails a wrong K2."""
    import torch

    from scflow_torch.training import (Config, ModelConfig, RenderConfig,
                                       build_model, device_normalize_images,
                                       make_eval_step, render_at_pose)

    cfg = Config(model=ModelConfig(**{"num_class": NUM_CLASS, "iters": ITERS,
                                      "test_iters": ITERS, **model_kw}),
                 render=RenderConfig(image_size=SIZE))
    raft = cfg.model.family != "scflow"
    model = build_model(cfg, device="cuda", seed=0)
    step = make_eval_step(model, renderer, cfg, device="cuda")
    run_path(f"{name}_warmup", step, batch, 1, 1, moves=not raft,
             k2_per_render=k2_per_step)
    run = run_path(name, step, batch, OPTIONS_STEPS, 1, moves=not raft,
                   k2_per_render=k2_per_step)
    cpu_model = build_model(cfg, device="cpu", seed=0)
    small = {k: v[:2] for k, v in batch.items()}
    t0 = time.perf_counter()
    if raft:
        with torch.inference_mode():
            rendered, _, _ = render_at_pose(
                renderer, small["ref_rotations"], small["ref_translations"],
                small["k"], small["labels"].long(), cfg.data.normalize_mean,
                cfg.data.normalize_std)
            real = device_normalize_images(small["real_images"], cfg)
            flows, occ = model(rendered, real)
            cpu_flows, cpu_occ = cpu_model(rendered.cpu(), real.cpu())
            nudged, _ = cpu_model(rendered.cpu() * (1 + 1e-6), real.cpu())
        spread = (nudged[-1] - cpu_flows[-1]).abs().max().item()
        err = {}
        for key, got, want, tol in (("flow", flows[-1], cpu_flows[-1],
                                     RAFT_FLOW_TOL),
                                    ("masks", occ[-1], cpu_occ[-1],
                                     RAFT_OCC_TOL)):
            diff = (got.cpu() - want).abs()
            err[key] = diff.max().item()
            ok = bool((diff <= tol["atol"] + tol["rtol"] * want.abs()).all())
            if key == "flow":
                ok = ok or err[key] <= 5 * spread
            check(ok, f"{name} cpu parity: {key} err {err[key]} (CPU "
                      f"spread {spread})")
        control = k2_control(model, rendered, real, cpu_flows[-1], spread)
        parity = dict(max_abs_err=err, flow_tol=RAFT_FLOW_TOL,
                      occlusion_tol=RAFT_OCC_TOL, cpu_flow_spread=spread,
                      flow_bound=f"flow_tol or 5 x cpu_flow_spread",
                      control=control)
    else:
        cpu_out = make_eval_step(cpu_model, cpu_renderer, cfg, device="cpu")(
            {k: v.cpu() for k, v in small.items()})
        gpu = {k: run["out"][k][:2].cpu() for k in ("rotations",
                                                    "translations")}
        rot_err = (gpu["rotations"] - cpu_out["rotations"]).abs().max().item()
        t_diff = (gpu["translations"] - cpu_out["translations"]).abs()
        t_allow = (POSE_TOL["trans_atol"]
                   + POSE_TOL["trans_rtol"] * cpu_out["translations"].abs())
        check(rot_err <= POSE_TOL["rot_atol"]
              and bool((t_diff <= t_allow).all()),
              f"{name} cpu parity: rotation {rot_err}, translation "
              f"{t_diff.max().item()}")
        parity = dict(rotation_max_abs_err=rot_err,
                      translation_max_abs_err=t_diff.max().item(), **POSE_TOL)
    step_ms = 1e3 * statistics.median(run["times"])
    return dict(options=model_kw, step_ms_median=step_ms,
                step_ms=[1e3 * t for t in run["times"]],
                frames_per_s=BATCH / (step_ms / 1e3),
                launches_per_step={"rasterize_tiles": run["k1"] // OPTIONS_STEPS,
                                   "instance_norm_fwd":
                                       run["k2"] // OPTIONS_STEPS},
                cpu_parity=dict(samples=2, cpu_seconds=time.perf_counter() - t0,
                                **parity),
                launches=(run["k1"], run["k2"], 0))


def phase_options(bank, renderer, batch) -> tuple:
    """Every ModelConfig option and the renderer's depth/mask-only form on
    the card (see the module doc). Returns (each path's launches of K1
    either form, the K2 forward and backward; the no-attribute K1 row of
    the kernels line with its launches by path)."""
    import torch

    from scflow_torch.rendering import Renderer, make_test_meshes
    from scflow_torch.training import (Config, DataConfig, ModelConfig,
                                       RenderConfig, build_points_bank)

    t_phase = time.perf_counter()
    small_k2 = k2_small()
    cpu_bank = make_test_meshes(NUM_CLASS, subdivisions=3, radius=60.0,
                                device="cpu")
    cpu_renderer = Renderer(cpu_bank, image_size=SIZE)
    main_poses = (batch["ref_rotations"].cpu(), batch["ref_translations"].cpu(),
                  batch["k"].cpu(), batch["labels"].long().cpu())
    frame_p = frame_poses(BATCH, 5, FRAME)
    with torch.inference_mode():
        bare = {"crop": k1_bare(bank, main_poses, SIZE),
                "frame": k1_bare(bank, frame_p, FRAME)}
    sil = {"crop": silhouette_path(bank, cpu_bank, main_poses, SIZE, 3),
           "frame": silhouette_path(bank, cpu_bank, frame_p, FRAME, 3)}
    agree = rasterizers_agree(bank, batch)
    evals = {name: options_eval(name, kw, renderer, cpu_renderer, batch, k2)
             for name, kw, k2 in (
                 ("options_a", OPTIONS_A, 30),
                 ("small", dict(net_type="Small"), SMALL_K2_PER_STEP),
                 ("raft_small", dict(family="raft_flow_mask",
                                     net_type="Small", iters=RAFT_ITERS,
                                     test_iters=RAFT_ITERS),
                  SMALL_K2_PER_STEP))}
    cfg = Config(model=ModelConfig(num_class=NUM_CLASS, iters=ITERS,
                                   test_iters=ITERS, remat=True, **OPTIONS_A),
                 render=RenderConfig(image_size=SIZE),
                 data=DataConfig(batch_size=TRAIN_BATCH))
    points = build_points_bank(bank, symmetric_classes=range(0, NUM_CLASS, 2),
                               num_points=cfg.loss.num_loss_points)
    train, run = drive_train("options_train", cfg, bank, points, 1, 2)
    train["cpu_parity"] = train_parity(cfg, run["renderer"], points,
                                       run["batch"])
    train_launches = train.pop("launches")
    del run
    emit(phase="options", k2_small_max_abs_err=small_k2,
         card_k1_no_attrs=bare, silhouette={
        k: {f: v for f, v in s.items() if f != "launches"}
        for k, s in sil.items()},
         rasterizers=agree,
         eval={k: {f: v for f, v in e.items() if f != "launches"}
               for k, e in evals.items()},
         train=dict(options=dict(OPTIONS_A, remat=True), **train),
         phase_seconds=time.perf_counter() - t_phase)
    paths = {name: e["launches"] for name, e in evals.items()}
    paths["options_train"] = train_launches
    for key, s in sil.items():
        k1, k2, k2b, k1_no_attrs = s["launches"]
        paths[f"silhouette_{key}"] = (k1 - k1_no_attrs, k2, k2b)
    crop = bare["crop"]
    row = dict(name="rasterize_tiles[no_attrs]", route="cuda",
               source="scflow_torch/ops/csrc/rasterize.cu",
               replaces="scflow_tpu/ops/rasterize_fast.py:122",
               max_abs_err=crop["max_abs_err"], ms=crop["ms"],
               call_ms=crop["call_ms"], plain_ms=crop["plain_ms"],
               bound_ms=crop["bound_ms"], bound_by=crop["bound_by"],
               library_ms=None, launches=sil["crop"]["launches"][3],
               launches_by_path={f"silhouette_{k}": s["launches"][3]
                                 for k, s in sil.items()})
    return paths, row


def phase_sync(step, batch, bank) -> dict:
    """One eval step, its batch already on the card, under the sync debug
    mode: "warn" first, so every synchronising call is listed by file and
    line, then "error", which must raise nothing. The same for the eval
    loop's pose-graph pass over the step's outputs (its slots in images of
    4 objects) and for one ``make_masked_metric_step`` (the on-device
    ADD(-S) accumulation)."""
    import warnings

    import torch

    from scflow_torch.parallel import MetricAccumulator
    from scflow_torch.training import build_points_bank
    from scflow_torch.training.evaluate import (_pose_graph_refine,
                                                make_masked_metric_step)

    n = batch["labels"].shape[0]
    metas = [(None, start, 4) for start in range(0, n, 4)]
    accumulator = MetricAccumulator(num_classes=NUM_CLASS)
    metric_step = make_masked_metric_step(
        step, build_points_bank(bank, num_points=1000), accumulator,
        device="cuda")
    acc_state = accumulator.init("cuda")

    def steps():
        out = step(batch)
        refined = _pose_graph_refine(out, batch, metas, BOP_BUDGET,
                                     torch.device("cuda"))
        metric_step(batch, acc_state)
        return dict(out, pg_rotations=refined["rotations"],
                    pg_translations=refined["translations"])

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            steps()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (setting the mode itself warns that it is a prototype feature)
    syncs = sorted({f"{w.filename}:{w.lineno}" for w in caught
                    if "called a synchronizing" in str(w.message)})
    check(not syncs, f"sync: the eval step synchronises at {syncs}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = steps()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out["translations"]).all()
               & torch.isfinite(out["pg_translations"]).all()),
          "sync: outputs not finite")
    instances = accumulator.compute(acc_state)["num_instances"]
    check(instances == 2 * n, f"sync: {instances} instances accumulated")
    fields = dict(batch=batch["labels"].shape[0], mode="error", raised=False,
                  synchronising_calls=syncs,
                  also=["pose_graph_pass", "masked_metric_step"])
    emit(phase="sync", **fields)
    return fields


def paeth_png(img) -> bytes:
    """A PNG of ``img`` (H, W, 3) uint8 whose every row uses the Paeth
    filter, the slowest for the port's decoder (cv2 picks filters per row;
    the port's own encoder writes filter 0)."""
    import struct
    import zlib

    import numpy as np

    h, w, c = img.shape
    px = img.reshape(h, w * c).astype(np.int16)
    up = np.vstack([np.zeros((1, w * c), np.int16), px[:-1]])
    left = np.hstack([np.zeros((h, c), np.int16), px[:, :-c]])
    upleft = np.hstack([np.zeros((h, c), np.int16), up[:, :-c]])
    p = left + up - upleft
    pa, pb, pc = (np.abs(p - q) for q in (left, up, upleft))
    pred = np.where((pa <= pb) & (pa <= pc), left,
                    np.where(pb <= pc, up, upleft))
    rows = np.hstack([np.full((h, 1), 4, np.uint8),
                      ((px - pred) % 256).astype(np.uint8)])

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def bop_cli_args(root: str, device: str, budget: int) -> list:
    return ["--data-root", f"{root}/test", "--ref-annots-root",
            f"{root}/init_poses", "--image-list",
            f"{root}/image_lists/test.txt", "--mesh-dir", f"{root}/models",
            "--num-classes", str(NUM_CLASS), "--image-size", str(SIZE[0]),
            "--iters", str(ITERS), "--slot-budget", str(budget),
            "--device", device]


def phase_eval_bop() -> tuple:
    """The BOP eval CLI on a tree the port writes on the card; returns the
    loop's launches of K1 and the K2 forward, and its results."""
    import os
    import tempfile
    from unittest import mock

    import numpy as np
    import torch

    import scflow_torch.test as cli
    import scflow_torch.training.evaluate as evaluate_mod
    from scflow_torch.data.imageio import imread
    from scflow_torch.data.loader import TestBatchBuilder
    from scflow_torch.metrics import ADDMetric
    from scflow_torch.tools.make_synthetic_bop import main as make_tree

    t_phase = time.perf_counter()
    item_s, process_s, slots, seen = [], [], [], {}

    def host_timed(fn, into):
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                into.append(time.perf_counter() - t0)
        return wrapped

    def packed(items, budget):
        for batch, metas in pack(items, budget):
            slots.append(int(batch["sample_valid"].sum()))
            yield batch, metas

    def loop(trainer, builder, metric, **kw):
        seen.update(trainer=trainer, builder=builder, metric=metric)
        t0 = time.perf_counter()
        out = evaluate(trainer, builder, metric, **kw)
        seen["loop_s"] = time.perf_counter() - t0
        return out

    pack, evaluate = evaluate_mod.pack_eval_batches, evaluate_mod.evaluate_dataset
    with tempfile.TemporaryDirectory(prefix="scflow_bop_") as root:
        t0 = time.perf_counter()
        tree = make_tree(["--out", root, "--num-images", str(BOP_IMAGES),
                          "--num-classes", str(NUM_CLASS), "--height",
                          str(BOP_FRAME[0]), "--width", str(BOP_FRAME[1]),
                          "--min-objects", str(BOP_OBJECTS[0]),
                          "--max-objects", str(BOP_OBJECTS[1]), "--seed", "0",
                          "--device", "cuda"])
        write_s = time.perf_counter() - t0
        patches = [
            mock.patch.object(TestBatchBuilder, "__getitem__", host_timed(
                TestBatchBuilder.__getitem__, item_s)),
            mock.patch.object(ADDMetric, "process", host_timed(
                ADDMetric.process, process_s)),
            mock.patch.object(evaluate_mod, "pack_eval_batches", packed),
            mock.patch.object(evaluate_mod, "evaluate_dataset", loop)]
        for p in patches:
            p.start()
        try:
            reset_counts()
            metrics, results = cli.main(bop_cli_args(root, "cuda", BOP_BUDGET)
                                        + ["--save-dir", f"{root}/res"])
            torch.cuda.synchronize()
            k1, k2, k2b = counts()
        finally:
            for p in patches:
                p.stop()
        batches = len(slots)
        check(k2b == 0 and (k1, k2) == (batches, 30 * batches),
              f"eval_bop: launches K1/K2 {k1}/{k2} over {batches} batches")
        check(sorted(r["img_id"] for r in results) == list(range(BOP_IMAGES)),
              "eval_bop: an image has no record")
        check(metrics["num_instances"] == tree["objects"] == sum(slots),
              f"eval_bop: {metrics['num_instances']} instances, "
              f"{tree['objects']} objects, {sum(slots)} slots")
        with open(f"{root}/res/000001/scene_gt.json") as f:
            written = json.load(f)
        for r in results:
            objs = written[str(r["img_id"])]
            for key, got in (("cam_R_m2c", r["rotations"]),
                             ("cam_t_m2c", r["translations"])):
                back = np.asarray([o[key] for o in objs], np.float32)
                check(np.array_equal(back, got.reshape(len(objs), -1)),
                      f"eval_bop: BOP file {key} of image {r['img_id']}")

        # one packed batch on the card: the loop's step, timed alone
        trainer, builder = seen["trainer"], seen["builder"]
        first = next(pack((builder[i] for i in range(BOP_IMAGES)),
                          BOP_BUDGET))[0]
        on_card = {k: torch.from_numpy(first[k]).cuda()
                   for k in evaluate_mod.EVAL_KEYS}
        step_ms = call_ms(lambda: trainer.eval_step(on_card), 5, 1)

        # the first images again, on the CPU, in one batch of their objects
        loop_s, card_records = seen["loop_s"], seen["metric"].records_arrays()
        n_cpu = sum(len(r["labels"]) for r in results[:BOP_CPU_IMAGES])
        t0 = time.perf_counter()
        with mock.patch.object(evaluate_mod, "evaluate_dataset", loop):
            _, cpu_results = cli.main(
                bop_cli_args(root, "cpu", n_cpu)
                + ["--limit", str(BOP_CPU_IMAGES), "--save-dir",
                   f"{root}/res_cpu"])
        cpu_s = time.perf_counter() - t0
        cpu_records = seen["metric"].records_arrays()
        check(len(cpu_results) == BOP_CPU_IMAGES,
              f"eval_bop: {len(cpu_results)} CPU results")
        rot_err = trans_err = 0.0
        for g, c in zip(results, cpu_results):
            rot_err = max(rot_err, np.abs(g["rotations"] - c["rotations"]).max())
            diff = np.abs(g["translations"] - c["translations"])
            check(bool((diff <= POSE_TOL["trans_atol"] + POSE_TOL["trans_rtol"]
                        * np.abs(c["translations"])).all()),
                  f"eval_bop cpu parity: translation err {diff.max()}")
            trans_err = max(trans_err, diff.max())
        check(rot_err <= POSE_TOL["rot_atol"],
              f"eval_bop cpu parity: rotation err {rot_err}")
        n_rec = len(cpu_records["add"])
        check(n_rec == n_cpu and np.array_equal(
            card_records["labels"][:n_rec], cpu_records["labels"]),
            "eval_bop cpu parity: other records")
        # each record within EVAL_ERR_RTOL, or within what the measured
        # pose gap can move an ADD: 3·rotation gap·point radius + √3·
        # translation gap (a refined pose's ADD can be a fraction of a mm)
        radius = trainer.points_bank.points.norm(dim=-1).max().item()
        pose_bound = float(3 * rot_err * radius + math.sqrt(3) * trans_err)
        add_abs = add_rel = 0.0
        for key in ("add", "adds"):
            diff = np.abs(card_records[key][:n_rec] - cpu_records[key])
            ref = np.abs(cpu_records[key])
            check(bool((diff <= np.maximum(EVAL_ERR_RTOL * ref,
                                           pose_bound)).all()),
                  f"eval_bop cpu parity: {key} records {diff.max()} apart "
                  f"(pose bound {pose_bound})")
            add_abs = max(add_abs, float(diff.max()))
            add_rel = max(add_rel, float((diff / ref).max()))

        png = np.random.default_rng(0).integers(0, 256, (*BOP_FRAME, 3),
                                                np.uint8)
        path = os.path.join(root, "paeth.png")
        with open(path, "wb") as f:
            f.write(paeth_png(png))
        t0 = time.perf_counter()
        check(np.array_equal(imread(path), png), "eval_bop: Paeth PNG decode")
        paeth_s = time.perf_counter() - t0

    emit(phase="eval_bop", images=BOP_IMAGES, frame=list(BOP_FRAME),
         classes=NUM_CLASS, objects=tree["objects"], image=list(SIZE),
         iters=ITERS, lowres=True, dtype="float32", slot_budget=BOP_BUDGET,
         tree_write_s=write_s, batches=batches,
         slot_share=sum(slots) / (batches * BOP_BUDGET),
         loop_s=loop_s, images_per_s=BOP_IMAGES / loop_s,
         objects_per_s=tree["objects"] / loop_s,
         packed_step_ms_median=step_ms,
         batches_x_step_s=batches * step_ms / 1e3,
         decode_crop_ms_per_image_median=1e3 * statistics.median(item_s),
         decode_crop_s_total=sum(item_s),
         match_add_ms_per_image_median=1e3 * statistics.median(process_s),
         match_add_s_total=sum(process_s),
         launches_per_batch={"rasterize_tiles": k1 / batches,
                             "instance_norm_fwd": k2 / batches},
         metric={k: metrics[k] for k in ("average/add_0.10d", "instance/auc",
                                         "num_instances")},
         cpu_parity={"images": BOP_CPU_IMAGES, "objects": n_cpu,
                     "rotation_max_abs_err": float(rot_err),
                     "translation_max_abs_err": float(trans_err),
                     "add_max_abs_err": add_abs, "add_max_rel_err": add_rel,
                     "add_rtol": EVAL_ERR_RTOL, "add_pose_bound": pose_bound,
                     "cpu_seconds": cpu_s, **POSE_TOL},
         paeth_png_decode_s=paeth_s, bop_file_equal=True,
         phase_seconds=time.perf_counter() - t_phase)
    return k1, k2, results


def phase_pose_graph(eval_results: list) -> tuple:
    """``test.py --pose-graph`` on the card: the eval_bop tree written
    again from its seed, evaluated at the CLI's width with the scene pose
    graph; returns the loop's launches of K1 and the K2 forward."""
    import tempfile
    from unittest import mock

    import numpy as np
    import torch

    import scflow_torch.test as cli
    import scflow_torch.training.evaluate as evaluate_mod
    from scflow_torch.tools.make_synthetic_bop import main as make_tree

    t_phase = time.perf_counter()
    pack, refine = evaluate_mod.pack_eval_batches, evaluate_mod._pose_graph_refine
    slots, calls = [], []

    def packed(items, budget):
        for batch, metas in pack(items, budget):
            slots.append(int(batch["sample_valid"].sum()))
            yield batch, metas

    def timed_refine(out, batch, metas, *args, **kw):
        # the pass between two syncs (the loop's overlap is lost here)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refined = refine(out, batch, metas, *args, **kw)
        torch.cuda.synchronize()
        calls.append(dict(s=time.perf_counter() - t0,
                          groups=sum(n >= 2 for _, _, n in metas)))
        if len(calls) == 1:
            calls[0].update(out=out, batch=batch, metas=metas,
                            refined=refined)
        return refined

    with tempfile.TemporaryDirectory(prefix="scflow_pose_graph_") as root:
        t0 = time.perf_counter()
        tree = make_tree(["--out", root, "--num-images", str(BOP_IMAGES),
                          "--num-classes", str(NUM_CLASS), "--height",
                          str(BOP_FRAME[0]), "--width", str(BOP_FRAME[1]),
                          "--min-objects", str(BOP_OBJECTS[0]),
                          "--max-objects", str(BOP_OBJECTS[1]), "--seed", "0",
                          "--device", "cuda"])
        write_s = time.perf_counter() - t0
        patches = [mock.patch.object(evaluate_mod, "pack_eval_batches", packed),
                   mock.patch.object(evaluate_mod, "_pose_graph_refine",
                                     timed_refine)]
        for p in patches:
            p.start()
        try:
            reset_counts()
            t0 = time.perf_counter()
            metrics, results = cli.main(bop_cli_args(root, "cuda", BOP_BUDGET)
                                        + ["--pose-graph", "--save-dir",
                                           f"{root}/res"])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            k1, k2, k2b = counts()
        finally:
            for p in patches:
                p.stop()
    batches = len(slots)
    check(k2b == 0 and (k1, k2) == (batches, 30 * batches),
          f"pose_graph: launches K1/K2 {k1}/{k2} over {batches} batches")
    pg = metrics.pop("pose_graph")
    check(pg["num_instances"] == metrics["num_instances"] == tree["objects"],
          f"pose_graph: {pg['num_instances']} and {metrics['num_instances']} "
          f"instances, {tree['objects']} objects")
    check(all(np.isfinite(v) for v in pg.values()), "pose_graph: metric")
    # the plain poses are eval_bop's
    by_id = {r["img_id"]: r for r in eval_results}
    rot_gap = trans_gap = 0.0
    for r in results:
        e = by_id[r["img_id"]]
        rot_gap = max(rot_gap, float(np.abs(r["rotations"]
                                            - e["rotations"]).max()))
        diff = np.abs(r["translations"] - e["translations"])
        check(bool((diff <= POSE_TOL["trans_atol"] + POSE_TOL["trans_rtol"]
                    * np.abs(e["translations"])).all()),
              f"pose_graph: plain translations {diff.max()} from eval_bop's")
        trans_gap = max(trans_gap, float(diff.max()))
    check(len(results) == BOP_IMAGES and rot_gap <= POSE_TOL["rot_atol"],
          f"pose_graph: plain rotations {rot_gap} from eval_bop's")
    multi = sum(c["groups"] for c in calls)
    check(len(calls) == batches and multi > 0,
          f"pose_graph: {len(calls)} passes, {multi} groups")

    # the first batch's pass on the CPU, on the card's network outputs: the
    # refined poses of its first 2 images of 2 or more objects
    first = calls[0]
    cpu_out = {k: v.cpu() for k, v in first["out"].items()}
    t0 = time.perf_counter()
    cpu = refine(cpu_out, first["batch"], first["metas"], BOP_BUDGET,
                 torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    groups = [(start, n) for _, start, n in first["metas"] if n >= 2][:2]
    rot_err = trans_err = 0.0
    moved = 0.0
    for start, n in groups:
        sl = slice(start, start + n)
        g_r = first["refined"]["rotations"][sl].cpu()
        g_t = first["refined"]["translations"][sl].cpu()
        rot_err = max(rot_err, (g_r - cpu["rotations"][sl]).abs().max().item())
        diff = (g_t - cpu["translations"][sl]).abs()
        check(bool((diff <= POSE_TOL["trans_atol"] + POSE_TOL["trans_rtol"]
                    * cpu["translations"][sl].abs()).all()),
              f"pose_graph cpu parity: translation err {diff.max().item()}")
        trans_err = max(trans_err, diff.max().item())
        moved = max(moved, (g_t - first["out"]["translations"][sl].cpu())
                    .abs().max().item())
    check(rot_err <= POSE_TOL["rot_atol"],
          f"pose_graph cpu parity: rotation err {rot_err}")
    delta = {k: pg[k] - metrics[k] for k in metrics if k.startswith("average/")}
    check(any(v != 0 for v in delta.values()),
          "pose_graph: the graph moved no pose enough to change a metric")
    pass_ms = [1e3 * c["s"] for c in calls]
    emit(phase="pose_graph", images=BOP_IMAGES, frame=list(BOP_FRAME),
         classes=NUM_CLASS, objects=tree["objects"], image=list(SIZE),
         iters=ITERS, lowres=True, dtype="float32", slot_budget=BOP_BUDGET,
         camera_only=True, tree_write_s=write_s, batches=batches,
         images_2_or_more_objects=multi, cli_s=cli_s,
         pass_ms_per_batch=pass_ms,
         pass_ms_per_batch_median=statistics.median(pass_ms),
         pass_ms_per_multi_object_image=sum(pass_ms) / multi,
         launches_per_batch={"rasterize_tiles": k1 / batches,
                             "instance_norm_fwd": k2 / batches},
         metric={k: metrics[k] for k in ("average/add_0.10d", "average/auc",
                                         "instance/auc", "num_instances")},
         pose_graph_metric={k: pg[k] for k in (
             "average/add_0.10d", "average/auc", "instance/auc",
             "num_instances")},
         delta=delta,
         plain_vs_eval_bop={"rotation_max_abs_err": rot_gap,
                            "translation_max_abs_err": trans_gap, **POSE_TOL},
         cpu_parity={"images": len(groups), "rotation_max_abs_err": rot_err,
                     "translation_max_abs_err": trans_err,
                     "max_pose_move_mm": moved, "cpu_pass_seconds": cpu_s,
                     **POSE_TOL},
         phase_seconds=time.perf_counter() - t_phase)
    return k1, k2


def phase_parallel(bank) -> tuple:
    """The parallel layer on one card: a world-1 NCCL group, 2 fit steps
    of the data-parallel path at the train phase's width against 2 plain
    steps on the same batch, the flagship forward of ``graft_entry.entry``
    and ``dryrun_multichip(1)``; returns the fit's launches of K1, the K2
    forward and backward."""
    import socket
    import tempfile

    import torch
    import torch.distributed as dist

    from scflow_torch.data import synthetic_batch
    from scflow_torch.graft_entry import dryrun_multichip, entry
    from scflow_torch.parallel import (initialize_distributed, shard_batch,
                                       world_size)
    from scflow_torch.rendering import Renderer
    from scflow_torch.training import (Config, DataConfig, ModelConfig,
                                       RenderConfig, build_model,
                                       build_points_bank, make_optimizer,
                                       make_train_step, onecycle_lr)
    from scflow_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    cfg = Config(model=ModelConfig(num_class=NUM_CLASS, iters=ITERS,
                                   test_iters=ITERS),
                 render=RenderConfig(image_size=SIZE),
                 data=DataConfig(batch_size=TRAIN_BATCH))
    points = build_points_bank(bank, symmetric_classes=range(0, NUM_CLASS, 2),
                               num_points=cfg.loss.num_loss_points)
    renderer = Renderer(bank, image_size=SIZE)
    batch = synthetic_batch(torch.Generator().manual_seed(0), renderer,
                            TRAIN_BATCH)
    model = build_model(cfg, device="cuda", seed=cfg.seed)
    step = make_train_step(model, renderer, points, cfg,
                           make_optimizer(cfg, model.parameters()),
                           device="cuda")
    plain = [step(batch) for _ in range(2)]
    torch.cuda.synchronize()

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{s.getsockname()[1]}"
    # one process starts no group (JAX's rule); the world-1 NCCL group
    # that drives the data-parallel path is started here
    dev = initialize_distributed(address, 1, 0, device="cuda")
    check(not dist.is_initialized(),
          "parallel: initialize_distributed started a group of 1")
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://{address}",
                            world_size=1, rank=0)
    init_s = time.perf_counter() - t0
    try:
        check(dist.get_backend() == "nccl" and world_size() == 1,
              f"parallel: backend {dist.get_backend()}, world {world_size()}")
        with tempfile.TemporaryDirectory(prefix="scflow_parallel_") as work:
            cfg.work_dir = work
            trainer = Trainer(cfg, renderer, points, device=dev)
            seen = []
            train_step = trainer.train_step

            def recorded(b):
                seen.append(train_step(b))
                return seen[-1]

            trainer.train_step = recorded
            reset_counts()
            t0 = time.perf_counter()
            trainer.fit(lambda _s: shard_batch(batch), num_steps=2)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            launches = counts()
        check(launches == (2, 60, 60),
              f"parallel: fit launches K1/K2 fwd/K2 bwd {launches}")
        check(torch.equal(seen[0]["loss"], plain[0]["loss"]),
              f"parallel: first loss {seen[0]['loss'].item()} vs "
              f"{plain[0]['loss'].item()}")
        loss2_rel = ((seen[1]["loss"] - plain[1]["loss"]).abs()
                     / plain[1]["loss"].abs()).item()
        check(loss2_rel <= 1e-4, f"parallel: second loss rel {loss2_rel}")
        lr_sum = onecycle_lr(0, cfg.optim) + onecycle_lr(1, cfg.optim)
        param_gap = max((a.detach() - b.detach()).abs().max().item()
                        for a, b in zip(trainer.model.parameters(),
                                        model.parameters()))
        check(param_gap <= RESUME_LR_MULT * lr_sum,
              f"parallel: parameters {param_gap} apart (lr sum {lr_sum})")

        fn, example = entry(device=dev)
        t0 = time.perf_counter()
        r, t = fn(*example)
        torch.cuda.synchronize()
        entry_ms = 1e3 * (time.perf_counter() - t0)
        check(tuple(r.shape) == (2, 3, 3) and tuple(t.shape) == (2, 3)
              and bool(torch.isfinite(r).all() & torch.isfinite(t).all()),
              "parallel: entry forward")
        t0 = time.perf_counter()
        dry_loss = dryrun_multichip(1, device="cuda")
        dry_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    emit(phase="parallel", backend="nccl", world=1, init_s=init_s,
         batch=TRAIN_BATCH, image=list(SIZE), classes=NUM_CLASS, iters=ITERS,
         dtype="float32", fit_steps=2, fit_s=fit_s,
         launches=list(launches),
         losses=[m["loss"].item() for m in seen],
         plain_losses=[m["loss"].item() for m in plain],
         first_loss_bit_equal=True, second_loss_rel_err=loss2_rel,
         param_max_abs_diff=param_gap,
         param_bound=RESUME_LR_MULT * lr_sum,
         entry_forward_ms=entry_ms, dryrun_loss=dry_loss, dryrun_s=dry_s,
         phase_seconds=time.perf_counter() - t_phase)
    return launches


def ycbv_layout(train: str, test: str, root: str) -> None:
    """Symlink two trees of ``make_synthetic_bop`` (a ``train_real`` and a
    ``test`` split) into the paths the YCB-V recipes read under ``root``."""
    import os

    ycbv = os.path.join(root, "data", "ycbv")
    os.makedirs(os.path.join(ycbv, "image_lists"))
    for src, dst in ((f"{train}/train_real", "train_real"),
                     (f"{test}/test", "test"), (f"{train}/models",
                                                "models_1024"),
                     (f"{train}/image_lists/train_real.txt",
                      "image_lists/train_real.txt"),
                     (f"{test}/image_lists/test.txt", "image_lists/test.txt")):
        os.symlink(src, os.path.join(ycbv, dst))
    os.makedirs(os.path.join(root, "data", "initial_poses"))
    os.symlink(f"{test}/init_poses",
               os.path.join(root, "data", "initial_poses", "ycbv_posecnn"))


def paeth_copy(train: str, out: str) -> str:
    """``train``'s train_real split with every frame re-encoded by
    :func:`paeth_png` (masks and annotations linked); returns its root."""
    import os

    from scflow_torch.data.imageio import imread

    seq = os.path.join(train, "train_real", "000001")
    dst = os.path.join(out, "000001")
    os.makedirs(os.path.join(dst, "rgb"))
    for name in os.listdir(seq):
        if name != "rgb":
            os.symlink(os.path.join(seq, name), os.path.join(dst, name))
    for name in os.listdir(os.path.join(seq, "rgb")):
        with open(os.path.join(dst, "rgb", name), "wb") as f:
            f.write(paeth_png(imread(os.path.join(seq, "rgb", name))))
    return out


def measure_loader(builder, alone: int, through_prefetch: int) -> dict:
    """Samples/s of ``builder()`` called alone, and through ``prefetch``'s
    3 workers (time to the last of ``through_prefetch`` batches); the
    alone run's host ms per sample to decode (frames, masks,
    backgrounds), crop, and augment."""
    from unittest import mock

    import scflow_torch.data.bop as bop_mod
    import scflow_torch.data.loader as loader_mod

    spent = {"decode": [], "crop": [], "augment": []}

    def timed(kind, fn):
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[kind].append(time.perf_counter() - t0)
        return wrapped

    targets = [(bop_mod, "imread", "decode"), (loader_mod, "imread", "decode"),
               (loader_mod, "crop_resize_pad", "crop")]
    targets += [(loader_mod, name, "augment") for name in (
        "random_background", "random_occlusion", "random_occlusion_v2",
        "default_train_augs")]
    patches = [mock.patch.object(mod, name, timed(kind, getattr(mod, name)))
               for mod, name, kind in targets]
    for p in patches:
        p.start()
    try:
        n = builder.cfg.data.batch_size
        t0 = time.perf_counter()
        for _ in range(alone):
            builder()
        alone_s = time.perf_counter() - t0
        per_sample = {f"{k}_ms_per_sample": 1e3 * sum(v) / (alone * n)
                      for k, v in spent.items()}
        batches = loader_mod.prefetch(builder)
        t0 = time.perf_counter()
        for _ in range(through_prefetch):
            next(batches)
        prefetch_s = time.perf_counter() - t0
        batches.close()
    finally:
        for p in patches:
            p.stop()
    return dict(samples_per_s_alone=alone * n / alone_s,
                batch_s_alone=alone_s / alone,
                samples_per_s_prefetch=through_prefetch * n / prefetch_s,
                batch_s_prefetch=prefetch_s / through_prefetch,
                batches=[alone, through_prefetch], **per_sample)


def train_bop_runs(root: str, base: list, patches: list, timed, losses):
    """The recipe run (eval on the test split) and the scene run of
    train_bop, in the layout's directory with ``patches`` applied; checks
    steps, finite losses, launches per fit step and that neither cv2 nor
    PIL was imported."""
    import torch

    import scflow_torch.train as cli

    for p in patches:
        p.start()
    try:
        reset_counts()
        t0 = time.perf_counter()
        trainer = cli.main(base + [
            "--steps", str(TRAIN_BOP_STEPS), "--eval-every",
            str(TRAIN_BOP_EVERY), "--eval-limit",
            str(TRAIN_BOP_TEST_IMAGES), "--work-dir", f"{root}/run"])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = counts()
        steps = timed.records.pop("train")
        recipe_losses, losses[:] = torch.stack(losses).cpu(), []
        t0 = time.perf_counter()
        scene = cli.main(base + [
            "--scene", "--scene-images", "4", "--slots-per-image", "4",
            "--steps", str(TRAIN_BOP_SCENE_STEPS), "--work-dir",
            f"{root}/scene"])
        torch.cuda.synchronize()
        scene_s = time.perf_counter() - t0
        scene_steps = timed.records.pop("train")
        scene_losses = torch.stack(losses).cpu()
    finally:
        for p in patches:
            p.stop()
    check(trainer.step == TRAIN_BOP_STEPS
          and scene.step == TRAIN_BOP_SCENE_STEPS,
          f"train_bop: {trainer.step} and {scene.step} steps")
    check(bool(torch.isfinite(recipe_losses).all()
               and torch.isfinite(scene_losses).all()),
          f"train_bop: losses {recipe_losses.tolist()} "
          f"{scene_losses.tolist()}")
    for _, _, n in steps + scene_steps:
        check(n == (1, 30, 30), f"train_bop: launches per fit step {n}")
    check("cv2" not in sys.modules and "PIL" not in sys.modules,
          "train_bop: cv2 or PIL was imported")
    with open(f"{root}/run/train_log.jsonl") as f:
        evals = [r for r in map(json.loads, f) if "eval/num_instances" in r]
    return dict(trainer=trainer, scene=scene, fit_s=fit_s, scene_s=scene_s,
                launches=launches, steps=steps, scene_steps=scene_steps,
                recipe_losses=recipe_losses, scene_losses=scene_losses,
                evals=evals)


def phase_train_bop(train_ms: float, smi: str) -> tuple:
    """Training from a BOP tree on disk through the training CLI's recipe
    path; returns the recipe run's launches of K1, the K2 forward and
    backward. ``train_ms``: the train phase's median bare step."""
    import copy
    import dataclasses
    import os
    import tempfile
    from unittest import mock

    import numpy as np
    import torch

    import scflow_torch.train as cli
    import scflow_torch.training.trainer as trainer_mod
    from scflow_torch import configs
    from scflow_torch.data.bop import SuperviseTrainDataset
    from scflow_torch.data.loader import TrainBatchBuilder
    from scflow_torch.tools.make_synthetic_bop import main as make_tree
    from scflow_torch.utils.tb_writer import encode_png

    t_phase = time.perf_counter()
    timed, builders, losses = Timed(), [], []

    def capture_prefetch(builder):
        builders.append(builder)
        return prefetch(builder)

    def loss_kept(step):
        def kept(batch):
            out = step(batch)
            losses.append(out["loss"])
            return out
        return kept

    def timed_train_step(*args, **kw):
        return timed("train", loss_kept(make_train_step(*args, **kw)))

    prefetch, make_train_step = cli.prefetch, trainer_mod.make_train_step
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="scflow_train_bop_") as root:
        tree_args = ["--num-classes", str(NUM_CLASS), "--height",
                     str(BOP_FRAME[0]), "--width", str(BOP_FRAME[1]),
                     "--min-objects", str(BOP_OBJECTS[0]), "--max-objects",
                     str(BOP_OBJECTS[1]), "--device", "cuda"]
        t0 = time.perf_counter()
        train = make_tree(["--out", f"{root}/train", "--split", "train_real",
                           "--num-images", str(TRAIN_BOP_IMAGES), "--seed",
                           "0", *tree_args])
        test = make_tree(["--out", f"{root}/test", "--split", "test",
                          "--num-images", str(TRAIN_BOP_TEST_IMAGES),
                          "--seed", "1", *tree_args])
        rng = np.random.default_rng(0)
        os.makedirs(f"{root}/bg")
        for i in range(TRAIN_BOP_BACKGROUNDS):
            with open(f"{root}/bg/{i:06d}.png", "wb") as f:
                f.write(encode_png(rng.integers(0, 256, (*BOP_FRAME, 3),
                                                np.uint8)))
        ycbv_layout(f"{root}/train", f"{root}/test", f"{root}/layout")
        write_s = time.perf_counter() - t0

        # the recipe, with backgrounds and both occlusions drawn
        recipe = configs.scflow_ycbv_real()
        recipe.config.data = dataclasses.replace(
            recipe.config.data, background_dir=f"{root}/bg",
            occlusion_p=TRAIN_BOP_OCCLUSION_P,
            occlusion_v2_p=TRAIN_BOP_OCCLUSION_P)
        patches = [
            mock.patch.dict(configs.RECIPES,
                            scflow_ycbv_real=lambda: copy.deepcopy(recipe)),
            mock.patch.object(cli, "prefetch", capture_prefetch),
            mock.patch.object(trainer_mod, "make_train_step",
                              timed_train_step),
            mock.patch.object(cli, "evaluate_dataset", timed(
                "eval", cli.evaluate_dataset))]
        base = ["--config", "scflow_ycbv_real", "--device", "cuda"]
        os.chdir(f"{root}/layout")          # the recipe's relative paths
        try:
            out = train_bop_runs(root, base, patches, timed, losses)
            # one disk batch: the card's train step against the CPU port's
            builder = builders[0]
            batch = {k: torch.from_numpy(v).cuda()
                     for k, v in builder().items()}
            parity = train_parity(out["trainer"].cfg, out["trainer"].renderer,
                                  out["trainer"].points_bank, batch)
            # the loader alone and through prefetch, on the tool's
            # filter-0 frames and on a copy re-encoded with Paeth rows
            loader = {"filter0": measure_loader(
                builder, *LOADER_BATCHES["filter0"])}
            paeth = SuperviseTrainDataset(
                paeth_copy(f"{root}/train", f"{root}/paeth"),
                f"{root}/train/image_lists/train_real.txt",
                class_names=builder.dataset.class_names,
                min_visib_fract=builder.dataset.min_visib_fract)
            loader["paeth"] = measure_loader(
                TrainBatchBuilder(paeth, builder.cfg, builder.mesh_points,
                                  builder.diameters), *LOADER_BATCHES["paeth"])
        finally:
            os.chdir(cwd)
    check(out["scene"].cfg.data.batch_size == 16
          and out["scene"].cfg.data.scene_mode, "train_bop: scene batch")
    evals = out["evals"]
    check(len(evals) == TRAIN_BOP_STEPS // TRAIN_BOP_EVERY
          and all(r["eval/num_instances"] == test["objects"] for r in evals),
          f"train_bop: eval records {evals}, {test['objects']} objects")
    steps, scene_steps = out["steps"], out["scene_steps"]

    # a fit step: from one train step's start to the next, less any eval
    # between them
    starts = [t0 for t0, _, _ in steps]
    evals_at = timed.records["eval"]
    fit_step_ms = [1e3 * (b - a - sum(e1 - e0 for e0, e1, _ in evals_at
                                      if a <= e0 < b))
                   for a, b in zip(starts, starts[1:])]
    step_in_fit_ms = [1e3 * (t1 - t0) for t0, t1, _ in steps]
    loader_batch_ms = 1e3 * loader["filter0"]["batch_s_prefetch"]
    bare = statistics.median(step_in_fit_ms)
    emit(phase="train_bop", card=smi, recipe="scflow_ycbv_real",
         batch=TRAIN_BATCH, image=list(SIZE), classes=NUM_CLASS, iters=ITERS,
         dtype="float32", frame=list(BOP_FRAME), train_images=train["images"],
         train_objects=train["objects"], test_images=test["images"],
         test_objects=test["objects"], backgrounds=TRAIN_BOP_BACKGROUNDS,
         occlusion_p=TRAIN_BOP_OCCLUSION_P, tree_write_s=write_s,
         steps=TRAIN_BOP_STEPS, eval_every=TRAIN_BOP_EVERY,
         fit_seconds=out["fit_s"],
         fit_step_ms_median=statistics.median(fit_step_ms),
         fit_step_ms=fit_step_ms, train_step_in_fit_ms=step_in_fit_ms,
         train_phase_step_ms_median=train_ms,
         eval_ms=timed.ms("eval"),
         eval={k: v for k, v in evals[-1].items() if k != "step"},
         losses=out["recipe_losses"].tolist(),
         launches=list(out["launches"]),
         launches_per_fit_step=dict(zip(
             ("rasterize_tiles", "instance_norm_fwd", "instance_norm_bwd"),
             steps[0][2])),
         scene={"images": 4, "slots_per_image": 4,
                "steps": TRAIN_BOP_SCENE_STEPS, "seconds": out["scene_s"],
                "step_ms": [1e3 * (t1 - t0) for t0, t1, _ in scene_steps],
                "losses": out["scene_losses"].tolist()},
         cpu_parity=parity, loader=loader,
         pace=("loader" if loader_batch_ms > bare else "step"),
         loader_batch_ms_prefetch=loader_batch_ms,
         train_step_in_fit_ms_median=bare,
         step_in_fit_over_bare_step=bare / train_ms,
         cv2_or_pil_imported=False,
         phase_seconds=time.perf_counter() - t_phase)
    return out["launches"]


def host_cpu() -> str:
    """The host CPU: its model name (``/proc/cpuinfo`` on x86, ``lscpu``
    elsewhere), architecture and core count."""
    import os
    import platform
    import shutil

    name = "unknown"
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                name = line.split(":", 1)[1].strip()
                break
    if name == "unknown" and shutil.which("lscpu"):
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=60).stdout
        for line in out.splitlines():
            if line.startswith(("Model name", "Vendor ID")):
                name = line.split(":", 1)[1].strip()
                if line.startswith("Model name"):
                    break
    return f"{name}, {platform.machine()}, {os.cpu_count()} cores"


def check_jpeg_fixtures(root: str) -> dict:
    """Decode every committed fixture with the port's decoder, color and
    gray, against the sha256 of cv2's arrays in the manifest (bit-equality
    with cv2 on a machine without it); time the 640×480 frames decoded by
    1 and by 3 threads (host ms per frame: wall time over frames)."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from scflow_torch.data.jpeg import decode_jpeg

    with open(f"{root}/manifest.json") as f:
        files = json.load(f)["files"]
    data = {}
    for m in files:
        with open(f"{root}/{m['file']}", "rb") as f:
            data[m["file"]] = f.read()
    for m in files:
        for gray, key in ((False, "rgb_sha256"), (True, "gray_sha256")):
            img = decode_jpeg(data[m["file"]], m["file"], gray)
            check(list(img.shape[:2]) == m["shape"]
                  and hashlib.sha256(img.tobytes()).hexdigest() == m[key],
                  f"train_pbr: {m['file']} gray={gray} differs from cv2")
    timing = {}
    for kind in ("frame", "textured"):
        blobs = [data[m["file"]] for m in files if m["kind"] == kind]
        jobs = blobs * DECODE_REPS
        timing[kind] = {}
        for threads in DECODE_THREADS:
            with ThreadPoolExecutor(threads) as pool:
                list(pool.map(decode_jpeg, blobs))          # warm
                t0 = time.perf_counter()
                list(pool.map(decode_jpeg, jobs))
                timing[kind][f"{threads}_threads"] = (
                    1e3 * (time.perf_counter() - t0) / len(jobs))
        timing[kind]["frames"] = len(blobs)
        timing[kind]["bytes_per_frame"] = sum(map(len, blobs)) / len(blobs)
    return dict(files=len(files), digests_equal=2 * len(files),
                decode_ms_per_frame=timing)


def pbr_layout(root: str, fixtures: str) -> dict:
    """The port's tool writes a ``train_pbr`` split on the card with the
    fixture frames' seed and arguments, whose PNG frames are swapped for
    the JPEG fixtures (image list rewritten to ``.jpg``), and a PNG
    ``train_real`` split; both, the meshes and the 3 JPEG backgrounds
    (``data/coco``) are linked where ``scflow_ycbv_mixpbr`` reads them."""
    import os

    import numpy as np

    from scflow_torch.data.imageio import imread
    from scflow_torch.tools.make_synthetic_bop import main as make_tree

    tree_args = ["--num-classes", str(NUM_CLASS), "--height",
                 str(BOP_FRAME[0]), "--width", str(BOP_FRAME[1]),
                 "--min-objects", str(BOP_OBJECTS[0]), "--max-objects",
                 str(BOP_OBJECTS[1]), "--device", "cuda"]
    pbr = make_tree(["--out", f"{root}/pbr", "--split", "train_pbr",
                     "--num-images", str(TRAIN_PBR_IMAGES), "--seed", "0",
                     *tree_args])
    real = make_tree(["--out", f"{root}/real", "--split", "train_real",
                      "--num-images", str(TRAIN_PBR_REAL_IMAGES), "--seed",
                      "1", *tree_args])
    rgb = f"{root}/pbr/train_pbr/000001/rgb"
    pngs = sorted(os.listdir(rgb))
    check(pngs == [f"{i:06d}.png" for i in range(TRAIN_PBR_IMAGES)],
          f"train_pbr: the tool's frames {pngs}")
    diffs = []
    for i, name in enumerate(pngs):
        jpg = f"{fixtures}/frame_{i:06d}.jpg"
        diffs.append(float(np.abs(imread(jpg).astype(np.int16)
                                  - imread(f"{rgb}/{name}")).mean()))
        os.remove(f"{rgb}/{name}")
        os.symlink(os.path.abspath(jpg), f"{rgb}/{i:06d}.jpg")
    # the fixtures re-encode the frames the tool renders for this seed
    check(max(diffs) < 4.0, f"train_pbr: JPEG frames vs the card's {diffs}")
    lst = f"{root}/pbr/image_lists/train_pbr.txt"
    with open(lst) as f:
        text = f.read()
    with open(lst, "w") as f:
        f.write(text.replace(".png", ".jpg"))
    data = f"{root}/layout/data"
    os.makedirs(f"{data}/ycbv/image_lists")
    os.makedirs(f"{data}/coco")
    for tree, split in ((f"{root}/pbr", "train_pbr"),
                        (f"{root}/real", "train_real")):
        os.symlink(f"{tree}/{split}", f"{data}/ycbv/{split}")
        os.symlink(f"{tree}/image_lists/{split}.txt",
                   f"{data}/ycbv/image_lists/{split}.txt")
    os.symlink(f"{root}/pbr/models", f"{data}/ycbv/models_1024")
    for name in sorted(os.listdir(fixtures)):
        if name.startswith("bg_"):
            os.symlink(os.path.abspath(f"{fixtures}/{name}"),
                       f"{data}/coco/{name}")
    return dict(pbr=pbr, real=real, frame_vs_card_mean_abs_diff=diffs)


def phase_train_pbr(train_ms: float, smi: str) -> tuple:
    """JPEG without cv2, and the PBR recipe from JPEG trees: the host
    library's build, every fixture against cv2's digests, decode times;
    ``scflow_torch.train.main --config scflow_ycbv_mixpbr`` (batch 16,
    256², 8 iterations, f32; backgrounds and object-paste occlusion at the
    recipe's p 0.3) for 4 steps over a JPEG train_pbr and a PNG
    train_real split written on the card. Returns the run's launches of
    K1, the K2 forward and backward."""
    import os
    import tempfile
    from unittest import mock

    import torch

    import scflow_torch.train as cli
    import scflow_torch.training.trainer as trainer_mod
    from scflow_torch.data import _build as host_build

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    host_build.library()
    build = dict(seconds=time.perf_counter() - t0,
                 cached=host_build.build_info["cached"],
                 library=host_build.build_info["path"])
    fixtures = os.path.abspath(JPEG_FIXTURES)
    t0 = time.perf_counter()
    decode = check_jpeg_fixtures(fixtures)
    seconds = dict(host_build=build["seconds"],
                   fixtures=time.perf_counter() - t0)

    timed, builders, losses = Timed(), [], []

    def capture_prefetch(builder):
        builders.append(builder)
        return prefetch(builder)

    def timed_train_step(*args, **kw):
        step = make_train_step(*args, **kw)

        def kept(batch):
            out = step(batch)
            losses.append(out["loss"])
            return out
        return timed("train", kept)

    prefetch, make_train_step = cli.prefetch, trainer_mod.make_train_step
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="scflow_train_pbr_") as root:
        t0 = time.perf_counter()
        trees = pbr_layout(root, fixtures)
        write_s = time.perf_counter() - t0
        os.chdir(f"{root}/layout")          # the recipe's relative paths
        try:
            with mock.patch.object(cli, "prefetch", capture_prefetch), \
                    mock.patch.object(trainer_mod, "make_train_step",
                                      timed_train_step):
                reset_counts()
                t0 = time.perf_counter()
                trainer = cli.main([
                    "--config", "scflow_ycbv_mixpbr", "--device", "cuda",
                    "--steps", str(TRAIN_PBR_STEPS), "--work-dir",
                    f"{root}/run"])
                torch.cuda.synchronize()
                fit_s = time.perf_counter() - t0
                launches = counts()
            builder = builders[0]
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).cuda()
                     for k, v in builder().items()}
            parity = train_parity(trainer.cfg, trainer.renderer,
                                  trainer.points_bank, batch)
            seconds["cpu_parity"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            loader = measure_loader(builder, *PBR_LOADER_BATCHES)
            seconds["loader"] = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
    steps = timed.records["train"]
    recipe_losses = torch.stack(losses).cpu()
    data = trainer.cfg.data
    check(trainer.step == TRAIN_PBR_STEPS, f"train_pbr: {trainer.step} steps")
    check(data.background_dir == "data/coco" and data.background_p == 0.3
          and len(builder._bg_paths) == 3, "train_pbr: the recipe's "
          f"backgrounds {data.background_dir} {builder._bg_paths}")
    check(len(builder.dataset) == TRAIN_PBR_IMAGES + TRAIN_PBR_REAL_IMAGES,
          f"train_pbr: {len(builder.dataset)} images in the dataset")
    check(bool(torch.isfinite(recipe_losses).all()),
          f"train_pbr: losses {recipe_losses.tolist()}")
    for _, _, n in steps:
        check(n == (1, 30, 30), f"train_pbr: launches per fit step {n}")
    check("cv2" not in sys.modules and "PIL" not in sys.modules,
          "train_pbr: cv2 or PIL was imported")
    starts = [t0 for t0, _, _ in steps]
    fit_step_ms = [1e3 * (b - a) for a, b in zip(starts, starts[1:])]
    step_in_fit_ms = [1e3 * (t1 - t0) for t0, t1, _ in steps]
    emit(phase="train_pbr", card=smi, host_cpu=host_cpu(),
         recipe="scflow_ycbv_mixpbr", batch=TRAIN_BATCH, image=list(SIZE),
         classes=NUM_CLASS, iters=ITERS, dtype="float32",
         host_library_build=build, fixtures=decode,
         frame=list(BOP_FRAME), pbr_images=trees["pbr"]["images"],
         pbr_objects=trees["pbr"]["objects"],
         real_images=trees["real"]["images"],
         real_objects=trees["real"]["objects"],
         frame_vs_card_mean_abs_diff=trees["frame_vs_card_mean_abs_diff"],
         tree_write_s=write_s, backgrounds=len(builder._bg_paths),
         background_p=data.background_p, occlusion_v2_p=data.occlusion_v2_p,
         steps=TRAIN_PBR_STEPS, fit_seconds=fit_s,
         fit_step_ms_median=statistics.median(fit_step_ms),
         fit_step_ms=fit_step_ms, train_step_in_fit_ms=step_in_fit_ms,
         train_phase_step_ms_median=train_ms,
         losses=recipe_losses.tolist(), launches=list(launches),
         launches_per_fit_step=dict(zip(
             ("rasterize_tiles", "instance_norm_fwd", "instance_norm_bwd"),
             steps[0][2])),
         cpu_parity=parity, loader=loader, cv2_or_pil_imported=False,
         seconds=dict(seconds, tree=write_s, fit=fit_s),
         phase_seconds=time.perf_counter() - t_phase)
    return launches


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
        k1_row = phase_k1(renderer, batch)
        fwd_rows = phase_k2()

    model = build_model(cfg, device="cuda", seed=0)
    step = make_eval_step(model, renderer, cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    run_path("warmup", step, batch, WARMUP, renders=1)
    main_run = run_path("main", step, batch, STEPS, renders=1)
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
    phase_sync(step, batch, bank)

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
    del model, step, cpu_model

    bwd_rows = phase_k2_bwd()
    train, train_ms = phase_train(bank)
    trainer = phase_trainer(train_ms)
    bf16 = phase_bf16(renderer, batch, cpu_out, gpu_out)
    train_bf16 = phase_train_bf16(bank)
    raft = phase_raft(renderer, batch)
    raft_train = phase_raft_train(bank)
    *eval_bop, eval_results = phase_eval_bop()
    pose_graph = phase_pose_graph(eval_results)
    train_bop = phase_train_bop(train_ms, smi)
    train_pbr = phase_train_pbr(train_ms, smi)
    parallel = phase_parallel(bank)
    options, bare_row = phase_options(bank, renderer, batch)
    emit(phase="done", seconds_total=time.perf_counter() - t_start)

    # ``launches``: the row's own path (f32 or bf16); beside it every
    # path's count, each read just after that path ran from 0
    main_counts = (main_run["k1"], main_run["k2"], 0)
    paths = {"main": main_counts, "bf16": (*bf16, 0), "raft": (*raft, 0),
             "train": train, "trainer": trainer, "train_bf16": train_bf16,
             "raft_train": raft_train, "eval_bop": (*eval_bop, 0),
             "train_bop": train_bop, "train_pbr": train_pbr,
             "pose_graph": (*pose_graph, 0), "parallel": parallel,
             **options}

    def by_path(i, names):
        return {p: paths[p][i] for p in names}

    k1_row.update(launches=main_run["k1"], launches_by_path=by_path(0, paths))
    fwd_rows[0].update(launches=main_run["k2"], launches_by_path=by_path(
        1, ("main", "raft", "train", "trainer", "raft_train", "eval_bop",
            "train_bop", "train_pbr", "pose_graph", "parallel", "options_a",
            "small", "raft_small", "options_train")))
    fwd_rows[1].update(launches=bf16[1], launches_by_path=by_path(
        1, ("bf16", "train_bf16")))
    bwd_rows[0].update(launches=train[2], launches_by_path=by_path(
        2, ("train", "trainer", "raft_train", "train_bop", "train_pbr",
            "parallel", "options_train")))
    bwd_rows[1].update(launches=train_bf16[2],
                       launches_by_path=by_path(2, ("train_bf16",)))
    rows = [k1_row, bare_row, *fwd_rows, *bwd_rows]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
