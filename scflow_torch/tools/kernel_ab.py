"""Time this tree's hand-written kernels against another tree's, in turns,
on one NVIDIA GPU.

Run from the root of a checkout, with another tree's sources unpacked
beside it (for example the parent commit: ``git archive <commit>
scflow_torch/ops/csrc | tar -x -C work_dirs/parent``):

    python3 -m scflow_torch.tools.kernel_ab --parent work_dirs/parent \
        [--sections k1 k2 k2_general k2_vector]

Both trees' ``scflow_torch/ops/csrc`` are built with ``nvcc`` (all
sources at once) into ``work_dirs/kernel_ab/``, loaded with ctypes and
timed with chip_smoke's ``device_ms`` on the same inputs, in turns
(parent, tree, tree, parent), so the card's clock and neighbours fall on
both alike. One JSON line per measurement, also written to ``--out``:

  k1   the tile pass at chip_smoke's shapes (the main path's render,
       batch 32, 256², d_attr 9; the no-attribute form at 32 × 256² and
       32 × 480×640) and its parts (``chip_smoke.k1_part_args``: binning
       alone, empty frame); every full call bit-equal to the plain
       version.
  k2   the cluster form's backward (batch 16) and forward (batch 32) at
       64 channels of 240², 256² and 240×320, f32 and bf16, both trees'
       results within chip_smoke's bounds of the plain versions.
  k2_general  the general form the same way at chip_smoke's general
       planes 64@23², 96@64² at storage offset 1, 128@175² and 64@56² at
       offset 3.
  k2_vector  the vector form the same way at the encoders' planes 64@128²,
       96@64² and 128@32².
Each K2 line also times one PyTorch launch that moves the same bytes on
the same inputs (a copy of x forward, x + g backward): a floor for one
launch at that size.

A tree whose backward entry takes no ticket counter (before the general
form's one-launch backward) is called without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "work_dirs" / "kernel_ab"
SOURCES = ("rasterize.cu", "instance_norm.cu")
CLUSTER_PLANES = ((64, 240, 240), (64, 256, 256), (64, 240, 320))
# (channels, height, width, storage offset) of chip_smoke's general planes
GENERAL_PLANES = ((64, 23, 23, 0), (96, 64, 64, 1), (128, 175, 175, 0),
                  (64, 56, 56, 3))
FRAME = (480, 640)
SECTIONS = ["k1", "k2", "k2_general", "k2_vector"]


def emit(out, **fields) -> None:
    line = json.dumps(fields)
    print(line, flush=True)
    out.write(line + "\n")


def build(trees: dict) -> dict:
    """{name: csrc dir} -> {name: (loaded library, whether its K1 entry
    takes the binning's scratch, whether its K2 backward entry takes a
    ticket counter)}, all sources compiled in parallel."""
    from scflow_torch.ops import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    objs, cmds = {}, []
    for name, csrc in trees.items():
        objs[name] = [str(OUT_DIR / f"{name}-{Path(s).stem}.o")
                      for s in SOURCES]
        cmds += [[nvcc, *_build.NVCC_FLAGS, "-c", str(csrc / s), "-o", o]
                 for s, o in zip(SOURCES, objs[name])]
    _build._run_all(cmds)
    libs = {}
    _build._run_all([[nvcc, "-shared", *_build.ARCH, "-o",
                      str(OUT_DIR / f"lib{name}.so"), *o]
                     for name, o in objs.items()])
    for name, csrc in trees.items():
        masks = "void* masks" in (csrc / "rasterize.cu").read_text()
        tickets = "void* tickets" in (csrc / "instance_norm.cu").read_text()
        libs[name] = (ctypes.CDLL(str(OUT_DIR / f"lib{name}.so")), masks,
                      tickets)
    return libs


def k1_caller(lib, with_masks: bool, args: tuple):
    """A call of ``lib``'s tile pass on ``args`` (rasterize_tiles'),
    outputs allocated once; ``with_masks``: the entry takes the binning
    launch's scratch (a tree whose K1 bins in a launch of its own)."""
    import torch

    from scflow_torch.ops import rasterize_fast as rf

    coeff, bbox, attr, h, w, d, k = args
    n, f = coeff.shape[:2]
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.scflow_rasterize_tiles
    fn.restype = i
    outs = (torch.empty(n, h, w, dtype=torch.int32, device="cuda"),
            torch.empty(n, h, w, device="cuda"),
            torch.empty(n, h, w, d, device="cuda"))
    masks = torch.empty(rf.mask_words(n, f, h, w), dtype=torch.int32,
                        device="cuda")
    ptrs = [coeff.data_ptr(), bbox.data_ptr(),
            None if attr is None else attr.data_ptr(),
            *(o.data_ptr() for o in outs)]
    if with_masks:
        ptrs.append(masks.data_ptr())
    fn.argtypes = [p] * len(ptrs) + [i] * 6 + [p]

    def call():
        err = fn(*ptrs, n, f, k, h, w, d,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"rasterize_tiles: CUDA error {err}")
        return outs

    return call


def k2_callers(lib, with_tickets: bool, x, xb, gb, scale, bias, pairs, xs):
    """(forward call, backward call) of ``lib``'s K2 entries on the next
    cold input of ``xs`` (shaped as x) / ``pairs`` (as xb, gb), and one
    call each on x and on (xb, gb) for the checks; outputs allocated
    once; ``with_tickets``: the backward entry takes a ticket counter
    (zeroed here once, as the wrapper's)."""
    import torch

    p, i = ctypes.c_void_p, ctypes.c_int
    fwd, bwd = lib.scflow_instance_norm_fwd, lib.scflow_instance_norm_bwd
    fwd.argtypes = [p] * 5 + [i] * 3 + [ctypes.c_float, i, p, p]
    bwd.argtypes = ([p] * (9 if with_tickets else 8) + [i] * 3
                    + [ctypes.c_float, i, p, p])
    counter = torch.zeros(1, dtype=torch.int32, device="cuda")
    fwd.restype = bwd.restype = i
    n, c, h, w = x.shape
    hw = h * w
    dt = 0 if x.dtype == torch.float32 else 1
    y, dx = torch.empty_like(x), torch.empty_like(xb)
    part = torch.empty(2 * xb.shape[0] * c, device="cuda")
    dscale, dbias = torch.empty(c, device="cuda"), torch.empty(c, device="cuda")
    form = ctypes.c_int()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def run_fwd(a):
        err = fwd(a.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                  y.data_ptr(), None, n * c, c, hw, 1e-5, dt,
                  ctypes.byref(form), stream())
        if err:
            raise RuntimeError(f"instance_norm_fwd: CUDA error {err}")
        return y

    def run_bwd(a, b):
        err = bwd(a.data_ptr(), b.data_ptr(), scale.data_ptr(),
                  dx.data_ptr(), part.data_ptr(), None,
                  *([counter.data_ptr()] if with_tickets else []),
                  dscale.data_ptr(), dbias.data_ptr(), xb.shape[0] * c, c,
                  hw, 1e-5, dt, ctypes.byref(form), stream())
        if err:
            raise RuntimeError(f"instance_norm_bwd: CUDA error {err}")
        return dx, dscale, dbias

    return (lambda: run_fwd(next(xs)), lambda: run_bwd(*next(pairs)),
            lambda: run_fwd(x), lambda: run_bwd(xb, gb))


def check_fwd(cs, y, x, scale, bias, what: str) -> float:
    """y against the plain version within chip_smoke's bounds
    (``k2_fwd_check``'s); returns the max abs error."""
    import torch

    from scflow_torch.ops.fused_norm import instance_norm_reference

    torch.cuda.synchronize()
    ref = instance_norm_reference(x, scale, bias).double()
    diff = (y.double() - ref).abs()
    step = (1e-5 * ref.abs() if x.dtype == torch.float32
            else cs.bf16_ulp(ref))
    cs.check(bool((diff <= 1e-5 + step).all()),
             f"{what}: y max err {diff.max().item()}")
    return diff.max().item()


def check_bwd(cs, got, x, g, scale, what: str) -> float:
    """dx, dscale, dbias against the plain version within chip_smoke's
    bounds (``k2_bwd_check``'s); returns dx's max abs error."""
    import torch

    from scflow_torch.ops.fused_norm import instance_norm_bwd_reference

    torch.cuda.synchronize()
    want = instance_norm_bwd_reference(x, g, scale)
    ref = want[0].double()
    diff = (got[0].double() - ref).abs()
    step = (1e-5 * ref.abs() if x.dtype == torch.float32
            else cs.bf16_ulp(ref))
    cs.check(bool((diff <= 1e-5 + step).all()),
             f"{what}: dx max err {diff.max().item()}")
    xf = x.float()
    mu = xf.mean((2, 3), keepdim=True)
    xhat = (xf - mu) * torch.rsqrt((xf - mu).square().mean(
        (2, 3), keepdim=True) + 1e-5)
    for a, b, terms in ((got[1], want[1], g.float() * xhat),
                        (got[2], want[2], g.float())):
        mag = terms.abs().sum((0, 2, 3)).double()
        cs.check(bool(((a.double() - b.double()).abs() <= 1e-5 * mag).all()),
                 f"{what}: dscale/dbias")
    return diff.max().item()


def turns(cs, callers: dict, order: list) -> dict:
    """device_ms of each caller in ``order`` (names may repeat): {name:
    [ms, ...]} in the order taken."""
    times = {}
    for name in order:
        times.setdefault(name, []).append(
            cs.device_ms(callers[name], cs.KERNEL_REPS))
    return times


def phase_k1(cs, libs: dict, out) -> None:
    import torch

    from scflow_torch.ops import rasterize_fast as rf
    from scflow_torch.rendering import Renderer, make_test_meshes

    bank = make_test_meshes(cs.NUM_CLASS, subdivisions=3, radius=60.0,
                            device="cuda")
    renderer = Renderer(bank, image_size=cs.SIZE)
    with torch.inference_mode():
        batch = cs.make_batch(renderer, cs.BATCH, seed=0)
        main = cs.tile_pass_args(renderer, batch, batch["ref_translations"])
    poses = {"crop": ((batch["ref_rotations"], batch["ref_translations"],
                       batch["k"], batch["labels"].long()), cs.SIZE),
             "frame": (tuple(v.cuda() for v in cs.frame_poses(
                 cs.BATCH, 5, FRAME)), FRAME)}
    cases = {"d9_main": main}
    for key, (pose, size) in poses.items():
        inp = Renderer(bank, image_size=size,
                       render_image=False).rasterizer_inputs(*pose)
        coeff, bbox, _, _, k = rf.tile_inputs(
            inp["tri_xy"], inp["tri_z"], inp["face_valid"], *size, None)
        cases[f"bare_{key}"] = (coeff, bbox, None, *size, 0, k)
    for case, args in cases.items():
        want = rf.rasterize_tiles_reference(*args)
        runs = {"full": args, **{name[:-3]: a for name, a in
                                 cs.k1_part_args(args).items()}}
        for part, a in runs.items():
            callers = {name: k1_caller(lib, masks, a)
                       for name, (lib, masks, _) in libs.items()}
            if part == "full":
                for name, call in callers.items():
                    got = call()
                    torch.cuda.synchronize()
                    cs.check(all(torch.equal(x.view(torch.int32),
                                             y.view(torch.int32))
                                 for x, y in zip(got, want)),
                             f"kernel_ab k1 {case}: {name} not bit-equal")
            times = turns(cs, callers, ["parent", "tree", "tree", "parent"])
            emit(out, phase="k1", case=case, part=part, ms=times,
                 frame=[a[3], a[4]], d_attr=a[5], faces=a[0].shape[1])


def k2_plane(cs, libs: dict, out, phase: str, c: int, h: int, w: int,
             offset: int, dtype) -> None:
    """Both trees' K2 forward (batch 32) and backward (batch 16) at
    ``c``@``h``×``w`` views starting ``offset`` elements into their
    buffers: each tree's results within chip_smoke's bounds of the plain
    version, then device ms in turns on inputs not in L2."""
    import torch

    x, g, scale, bias = cs.k2_plane_inputs(cs.BATCH, c, h, w, offset, 0.0,
                                           h * w, dtype)
    xb, gb = x[:cs.TRAIN_BATCH], g[:cs.TRAIN_BATCH]
    if offset:                # the train batch's views, offset as well
        xb, gb, _, _ = cs.k2_plane_inputs(cs.TRAIN_BATCH, c, h, w, offset,
                                          0.0, h * w, dtype)
    pairs, _ = cs.cold_pairs(xb, gb)
    xs = cs.cold_inputs(x)
    calls = {name: k2_callers(lib, tickets, x, xb, gb, scale, bias, pairs,
                              xs)
             for name, (lib, _, tickets) in libs.items()}
    what = f"kernel_ab {phase} {dtype} {c}@{h}x{w}+{offset}"
    fwd_errs = {name: check_fwd(cs, v[2](), x, scale, bias, f"{what} {name}")
                for name, v in calls.items()}
    bwd_errs = {name: check_bwd(cs, v[3](), xb, gb, scale, f"{what} {name}")
                for name, v in calls.items()}
    order = ["parent", "tree", "tree", "parent"]
    bwd = turns(cs, {n: v[1] for n, v in calls.items()}, order)
    fwd = turns(cs, {n: v[0] for n, v in calls.items()}, order)
    # a floor beside them: one PyTorch launch that moves the same bytes
    # (forward: x copied out; backward: x + g written out), same inputs
    y, dx = torch.empty_like(x), torch.empty_like(xb)
    floor = dict(fwd=cs.device_ms(lambda: y.copy_(next(xs)), cs.KERNEL_REPS),
                 bwd=cs.device_ms(lambda: torch.add(*next(pairs), out=dx),
                                  cs.KERNEL_REPS))
    emit(out, phase=phase, plane=[c, h, w], storage_offset=offset,
         dtype=str(dtype), fwd_batch=cs.BATCH, bwd_batch=cs.TRAIN_BATCH,
         fwd_ms=fwd, bwd_ms=bwd, same_bytes_one_launch_ms=floor,
         fwd_max_abs_err=fwd_errs, bwd_dx_max_abs_err=bwd_errs)
    del x, g, xb, gb, pairs, xs, calls, y, dx
    torch.cuda.empty_cache()


def k2_planes(cs) -> dict:
    """The K2 sections' planes: (channels, height, width, offset)."""
    return {"k2_general": GENERAL_PLANES,
            "k2_vector": [(c, s, s, 0) for c, s in cs.IN_SHAPES],
            "k2": [(*plane, 0) for plane in CLUSTER_PLANES]}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="root of the other tree (holds scflow_torch/ops/csrc)")
    ap.add_argument("--out", default=str(OUT_DIR / "kernel_ab.jsonl"))
    ap.add_argument("--sections", nargs="+", default=SECTIONS,
                    choices=SECTIONS, help="the sections to run, in order")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build({"parent": Path(args.parent) / "scflow_torch" / "ops" / "csrc",
                  "tree": ROOT / "scflow_torch" / "ops" / "csrc"})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as out:
        emit(out, phase="env", gpu=torch.cuda.get_device_name(0),
             nvidia_smi=smi, torch=torch.__version__)
        for section in args.sections:
            if section == "k1":
                phase_k1(cs, libs, out)
                continue
            for plane in k2_planes(cs)[section]:
                for dtype in (torch.float32, torch.bfloat16):
                    k2_plane(cs, libs, out, section, *plane, dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
