"""The port's profiling tools (``scflow_torch/tools/{comm_bench,
profile_roofline,profile_trace}.py``) against the JAX package's tools, and
the pose graph's products free of matmuls.

- ``comm_bench`` on 2 gloo ranks: the JAX tool's metric names, units and
  keys, an exact all-reduce (each rank checks it), and the DP step's
  ``Config`` field by field against the one the JAX tool builds.
- ``profile_roofline``: the encoders' and the correlation build's flops
  within 10% of XLA's ``cost_analysis`` of the JAX phases at 2 × 64² with
  carried weights (FlopCounterMode counts a padded convolution's every
  tap; XLA seems to count only those inside the frame); K1's and K2's
  declared work equal to the figures behind ``PERF.md`` §6's bounds;
  their plain versions counted as that declared work and nothing else.
- ``profile_trace`` on the CPU (op self time) at batch 1, one iteration:
  each attribution sums to the trace's total, every source is a file of
  ``scflow_torch/`` or ``?``; ``build_step``'s ``Config`` against the JAX
  tool's (read in a process of its own: the JAX tool turns on JAX's
  persistent compilation cache when imported).
- The pose graph's 3×3 products dispatch no matmul (so no TF32 setting
  reaches them); the card's check that it is bit-equal with TF32 on and
  off is in ``test_torch_port_kernels.py`` (JAX-free, as the card is).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from port_common import (jax_refiner_variables, one_torch_thread,  # noqa: F401
                         port_refiner)
from scflow_torch.ops import rasterize_fast as rf
from scflow_torch.ops.fused_norm import (bwd_work, fwd_work, instance_norm,
                                         instance_norm_bwd_reference,
                                         instance_norm_reference)
from scflow_torch.tools import comm_bench, profile_roofline, profile_trace
from scflow_torch.utils.profiling import PEAK_BYTES, count_work

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))     # the JAX tools, by module name
# JAX's DataConfig fields the port leaves out on purpose (one crop path
# with the C++ crop's semantics)
JAX_ONLY_FIELDS = {("data", "use_native"), ("data", "native_crop")}


def assert_same_config(port, jax_fields: dict) -> None:
    """The port's ``Config`` equal, field by field, to the JAX ``Config``
    given as ``dataclasses.asdict`` JSON; JAX's extra fields are only
    ``JAX_ONLY_FIELDS``."""
    ours = json.loads(json.dumps(dataclasses.asdict(port)))
    extra = {(sec, f) for sec, v in jax_fields.items()
             if isinstance(v, dict) for f in v if f not in ours[sec]}
    assert extra <= JAX_ONLY_FIELDS, extra
    for sec, v in ours.items():
        if isinstance(v, dict):
            for f, x in v.items():
                assert x == jax_fields[sec][f], (sec, f, x, jax_fields[sec][f])
        else:
            assert v == jax_fields[sec], (sec, v, jax_fields[sec])


# -- comm_bench ---------------------------------------------------------

def test_comm_bench_two_gloo_ranks(capsys):
    import torch_parallel_ranks as ranks

    with ranks.one_thread_each():
        lines = comm_bench.main(["--device", "cpu", "--world", "2",
                                 "--sizes-mb", "0.25", "1", "--image-size",
                                 "64"])
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert printed == json.loads(json.dumps(lines))
    mesh, *bw, dp = lines
    assert mesh == {"metric": "mesh_devices", "value": 2, "unit": "devices",
                    "platform": "cpu"}
    assert [r["payload_mb"] for r in bw] == [0.25, 1.0]
    for r in bw:
        assert set(r) == {"metric", "payload_mb", "value", "unit",
                          "latency_ms"}
        assert (r["metric"], r["unit"]) == ("psum_allreduce_busbw", "GB/s")
        assert r["value"] > 0 and r["latency_ms"] > 0
    assert set(dp) == {"metric", "devices", "value", "unit", "t_1dev_ms",
                       "t_ndev_ms", "rank0_launches"}
    assert (dp["metric"], dp["unit"], dp["devices"]) == (
        "dp_weak_scaling_efficiency", "ratio", 2)
    assert 0 < dp["value"] <= 1.0 and dp["t_1dev_ms"] > 0
    assert dp["rank0_launches"] == {"rasterize_tiles": 0,
                                    "instance_norm_fwd": 0,
                                    "instance_norm_bwd": 0}   # plain on CPU


def test_comm_bench_allreduce_check_is_exact():
    import torch_parallel_ranks as ranks
    from scflow_torch.parallel.mesh import spawn

    with ranks.one_thread_each():
        got = spawn(ranks.allreduce_off_by_one, 2, ([0.01],))
    assert all(g and "not 2 × x" in g for g in got), got


def test_comm_bench_config_is_jax_tools(monkeypatch, capsys):
    """The JAX tool's one-device step, stopped at ``build_model``: its
    ``Config`` is the port's ``dp_config`` at the same global batch."""
    import comm_bench as jax_tool                           # tools/
    import scflow_tpu.training as jt

    class Built(Exception):
        pass

    def capture(cfg):
        raise Built(cfg)

    monkeypatch.setattr(jt, "build_model", capture)
    monkeypatch.setattr(sys, "argv", ["comm_bench.py", "--sizes-mb", "0.004",
                                      "--batch-per-device", "3",
                                      "--image-size", "96"])
    with pytest.raises(Built) as built:
        jax_tool.main()
    jax_cfg = json.loads(json.dumps(dataclasses.asdict(built.value.args[0])))
    assert_same_config(comm_bench.dp_config(3, 96), jax_cfg)
    # n ranks: the same but the global batch
    jax_cfg["data"]["batch_size"] = 6
    assert_same_config(comm_bench.dp_config(6, 96), jax_cfg)


# -- profile_roofline ---------------------------------------------------

@pytest.fixture(scope="module")
def carried():
    """(JAX refiner bound to its variables, its config, the port's
    phases at 2 × 64², iters 2, f32 with the same weights)."""
    model, cfg, variables = jax_refiner_variables(image=(64, 64), iters=2)
    port, _ = port_refiner(variables, image=(64, 64), iters=2)
    phases = dict(profile_roofline.build_phases(
        2, 2, "float32", 1, "cpu", num_class=3, size=(64, 64), model=port))
    return model.bind(variables), cfg, phases


def test_roofline_flops_match_xla_cost_analysis(carried):
    from profile_roofline import _cost                      # tools/
    from scflow_tpu.models.corr import correlation_pyramid

    bound, cfg, phases = carried
    img = jnp.zeros((2, 64, 64, 3), jnp.float32)
    jax_phases = {
        "enc_render": (lambda i: bound.render_encoder(i, False), (img,)),
        "enc_real": (lambda i: bound.real_encoder(i, False), (img,)),
        "enc_context": (lambda i: bound.context(i, False), (img,)),
        "corr_build(+2enc)": (lambda a, b: correlation_pyramid(
            bound.render_encoder(a, False), bound.real_encoder(b, False),
            cfg.model.num_levels), (img, img)),
    }
    for name, (fn, args) in jax_phases.items():
        xla_flops, _ = _cost(fn, *args)
        row = profile_roofline.measure(name, phases[name], 0,
                                       torch.device("cpu"), None, None)
        assert row["ms"] is None and row["pct_peak_flops"] is None
        assert abs(row["flops"] / xla_flops - 1) <= 0.10, (
            name, row["flops"], xla_flops)


def test_roofline_main_on_cpu(capsys, monkeypatch):
    rows = profile_roofline.main(["--device", "cpu", "--batch", "1",
                                  "--iters", "1", "--subdivisions", "1",
                                  "--steps", "1", "--dtype", "float32"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# device=cpu")
    assert json.loads(out[-1]) == json.loads(json.dumps(rows))
    assert [r["phase"] for r in rows] == list(profile_roofline.PHASES)
    for r in rows:
        assert r["ms"] > 0 and r["flops"] > 0 and r["bytes"] > 0
        assert r["pct_peak_flops"] is None and r["pct_peak_bw"] is None
        assert r["gflops"] == r["flops"] * 1e-9


def test_unknown_card_has_no_peaks():
    from scflow_torch.utils.profiling import device_peaks

    assert device_peaks("NVIDIA H100 80GB HBM3")["bytes"] == PEAK_BYTES
    with pytest.raises(ValueError, match="NVIDIA A100-SXM4-40GB"):
        device_peaks("NVIDIA A100-SXM4-40GB")


def test_tools_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (comm_bench.main, profile_roofline.main, profile_trace.main):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            main(["--device", "cuda"])


# the encoders' instance-norm shapes at the eval batch (channels, side), 10
# launches each per step; PERF.md §6's bounds of K2 in ms per step
IN_SHAPES = ((64, 128), (96, 64), (128, 32))
K2_BOUNDS = {("fwd", torch.float32): 1.202, ("fwd", torch.bfloat16): 0.601,
             ("bwd", torch.float32): 0.901, ("bwd", torch.bfloat16): 0.451}


@pytest.mark.parametrize("direction,dtype", list(K2_BOUNDS))
def test_k2_declared_work_is_perf_bound(direction, dtype):
    batch = 32 if direction == "fwd" else 16
    work = fwd_work if direction == "fwd" else bwd_work
    moved = sum(10 * work(torch.empty(batch, c, s, s, dtype=dtype,
                                      device="meta"))[1]
                for c, s in IN_SHAPES)
    assert round(1e3 * moved / PEAK_BYTES, 3) == K2_BOUNDS[direction, dtype]


def _tile_args(n, size=(256, 256), classes=21, seed=0):
    from scflow_torch.geometry import quaternion_to_matrix
    from scflow_torch.rendering import Renderer, make_test_meshes

    g = torch.Generator().manual_seed(seed)
    renderer = Renderer(make_test_meshes(classes, subdivisions=3,
                                         radius=60.0, device="cpu"),
                        image_size=size)
    r = quaternion_to_matrix(torch.randn(n, 4, generator=g))
    t = torch.cat([torch.rand(n, 2, generator=g) * 60 - 30,
                   torch.rand(n, 1, generator=g) * 400 + 500], dim=-1)
    k = torch.tensor([[500.0, 0, size[1] / 2], [0, 500.0, size[0] / 2],
                      [0, 0, 1]]).expand(n, 3, 3)
    inp = renderer.rasterizer_inputs(r, t, k, torch.randint(
        0, classes, (n,), generator=g))
    coeff, bbox, attr, d, kf = rf.tile_inputs(
        inp["tri_xy"], inp["tri_z"], inp["face_valid"], *size,
        inp["tri_attrs"])
    return coeff, bbox, attr, *size, d, kf


def test_k1_declared_work_is_perf_bound():
    """At the main render (32 × 256², 21 classes of 1280 faces, 9
    attributes) K1 moves 99.0 MB, PERF.md §6's bound of 0.0295 ms."""
    coeff, bbox, _, h, w, d, kf = _tile_args(32)
    assert (coeff.shape[1], d) == (1280, 9)
    ops, moved = rf.tile_pass_work(coeff, bbox, h, w, d, kf)
    assert moved == 98_992_128
    assert round(1e3 * moved / PEAK_BYTES, 4) == 0.0295
    assert ops > 0 and ops % (rf.OPS_PER_PAIR * rf.TILE ** 2) == 0


def test_plain_versions_count_as_their_kernels():
    args = _tile_args(2, size=(64, 64), classes=3)
    for fn in (rf.rasterize_tiles, rf.rasterize_tiles_reference):
        with count_work() as work:
            fn(*args)
        assert (work.flops, work.bytes) == rf.tile_pass_work(
            *args[:2], *args[3:])
        assert work.kernels == {"rasterize_tiles": 1}

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 16, 16, generator=g)
    scale, bias = torch.rand(8, generator=g) + 0.5, torch.randn(8, generator=g)
    with count_work() as work:
        instance_norm_reference(x, scale, bias)
    assert (work.flops, work.bytes) == fwd_work(x)
    with count_work() as work:
        instance_norm_bwd_reference(x, x, scale)
    assert (work.flops, work.bytes) == bwd_work(x)
    # through autograd: both declared, nothing else of theirs counted
    xg = x.clone().requires_grad_()
    with count_work() as work:
        instance_norm(xg, scale, bias).backward(x)
    assert work.kernels == {"instance_norm_fwd": 1, "instance_norm_bwd": 1}
    assert work.flops == fwd_work(x)[0] + bwd_work(x)[0]


def test_count_work_counts_ops():
    x, wt = torch.randn(2, 8, 16, 16), torch.randn(16, 8, 3, 3)
    with count_work() as work:
        y = torch.nn.functional.conv2d(x, wt, padding=1)
        y.view(2, 16, 256).permute(0, 2, 1)        # views: no bytes
    assert work.flops == 2 * y.numel() * 8 * 9
    assert work.bytes == 4 * (x.numel() + wt.numel() + y.numel())


# -- profile_trace ------------------------------------------------------

@pytest.mark.parametrize("mode", ["eval", "train"])
def test_trace_attributions_on_cpu(mode):
    fn, _ = profile_trace.build_step(1, mode, iters=1, device="cpu")
    fn()
    prof, wall = profile_trace.trace_steps(fn, 1, "cpu")
    s = profile_trace.summarize(prof, "cpu", 1, 10)
    total = s["traced_ms_per_step"]
    assert wall > 0 and total > 0
    for got in (sum(s["by_category"].values()), s["by_source_sum_ms"],
                s["by_op_sum_ms"], s["total_ms_per_step"]):
        assert got == pytest.approx(total, rel=1e-9)
    assert set(s["by_category"]) <= {c for c, _ in profile_trace.CATEGORIES
                                     } | {"other"}
    assert "convolution" in s["by_category"]
    for src in s["sources"]:
        assert src == "?" or (REPO / "scflow_torch" / src.split("(")[0]
                              ).is_file(), src
    # eval: every op has a source line; train: the gradients' accumulation
    # has no forward op (backward ops take their forward op's source)
    assert s["unattributed_share"] < (0.01 if mode == "eval" else 0.1)
    if mode == "train":
        assert any(k.startswith("aten::convolution_backward | models/")
                   for k in s["by_op_top"])


def _event(name, device="cpu", us=0.0, kernels=(), parent=None, seq=-1,
           annotation=False):
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import Kernel

    e = SimpleNamespace(
        name=name, device_type=getattr(DeviceType, device.upper()),
        is_user_annotation=annotation, sequence_nr=seq, cpu_parent=parent,
        cpu_children=[], self_cpu_time_total=us,
        time_range=SimpleNamespace(elapsed_us=lambda: us),
        kernels=[Kernel(k, 0, d) for k, d in kernels])
    if parent is not None:
        parent.cpu_children.append(e)
    return e


def test_trace_records_of_a_card_trace():
    """The card's linking, on a made-up trace: a kernel listed under its
    op and again under the profiler's bookkeeping event inside it counts
    once, at the op's source range; a backward kernel takes its forward
    op's source; K1's and K2's kernels take their wrapper's source by
    name, linked or not, once; the source ranges' device events are not
    kernels."""
    from types import SimpleNamespace

    from scflow_torch.utils.profiling import SOURCE_PREFIX

    outer = _event("aten::conv2d", seq=7)
    mode = _event("PythonDispatchMode", parent=outer)
    rng = _event(SOURCE_PREFIX + "models/layers.py(40): forward",
                 parent=mode)
    inner = _event("aten::cudnn_convolution", parent=rng,
                   kernels=[("fprop_a", 3.0)])
    _event("Activity Buffer Request", parent=inner,
           kernels=[("fprop_a", 3.0)])
    node = _event("autograd::engine::evaluate_function: "
                  "ConvolutionBackward0", seq=7)
    _event("aten::convolution_backward", parent=node,
           kernels=[("dgrad_b", 5.0)])
    norm = _event(SOURCE_PREFIX + "models/layers.py(52): forward",
                  annotation=True,
                  kernels=[("instance_norm_fwd_kernel<float>", 1.0)])
    device = [_event("fprop_a", "cuda", 3.0), _event("dgrad_b", "cuda", 5.0),
              _event("instance_norm_fwd_kernel<float>", "cuda", 1.0),
              _event("instance_norm_bwd_reduce", "cuda", 0.25),
              _event("rasterize_tiles_kernel<9>", "cuda", 2.0),
              _event(SOURCE_PREFIX + "models/layers.py(40): forward", "cuda",
                     3.5, annotation=True),
              _event("mystery_kernel", "cuda", 0.5)]
    events = [outer, mode, rng, inner, *inner.cpu_children, node,
              *node.cpu_children, norm, *device]
    recs, traced = profile_trace.records(
        SimpleNamespace(events=lambda: events), "cuda")
    got = {(n, src): us for n, us, src in recs}
    wrappers = profile_trace.wrapper_sources()
    assert got == {
        ("fprop_a", "models/layers.py(40): forward"): 3.0,
        ("dgrad_b", "models/layers.py(40): forward"): 5.0,
        ("instance_norm_fwd_kernel<float>", wrappers["k2_fwd"]): 1.0,
        ("instance_norm_bwd_reduce", wrappers["k2_bwd"]): 0.25,
        ("rasterize_tiles_kernel<9>", wrappers["k1"]): 2.0,
        ("mystery_kernel", "?"): 0.5}
    assert traced == 11.75
    assert wrappers["k1"].startswith("ops/rasterize_fast.py(")
    assert wrappers["k2_bwd"].startswith("ops/fused_norm.py(")


def test_traced_kernels_of_a_card_trace():
    """``checked_trace``'s count of K1 and K2 kernels: each device event
    of theirs once, by name without template arguments; CPU events that
    list them and source ranges named after their wrappers are none."""
    import collections
    from types import SimpleNamespace

    from scflow_torch.utils.profiling import SOURCE_PREFIX, traced_kernels

    events = [
        _event("aten::conv2d", kernels=[("rasterize_tiles_kernel<9>", 2.0)]),
        _event("void rasterize_tiles_kernel<9>(...)", "cuda", 2.0),
        _event("bin_chunks_kernel", "cuda", 1.0),
        _event("instance_norm_fwd_kernel<float>", "cuda", 1.0),
        _event("instance_norm_fwd_kernel<float>", "cuda", 1.0),
        _event("instance_norm_bwd_reduce", "cuda", 0.5),
        _event(SOURCE_PREFIX + "ops/fused_norm.py(60): "
               "instance_norm_reference", "cuda", 3.0, annotation=True),
        _event("fprop_a", "cuda", 3.0)]
    assert traced_kernels(SimpleNamespace(events=lambda: events)) == \
        collections.Counter({"rasterize_tiles_kernel": 1,
                             "bin_chunks_kernel": 1,
                             "instance_norm_fwd_kernel": 2,
                             "instance_norm_bwd_reduce": 1})



def test_launched_kernels_follow_the_backward_form():
    """``launched_kernels``: every backward launch but the general form's
    adds one reduce kernel (the general backward sums dscale and dbias in
    its own kernel), counted from the wrappers' launches by form."""
    import collections

    from scflow_torch.ops.fused_norm import instance_norm_bwd, instance_norm_fwd
    from scflow_torch.utils.profiling import launch_snapshot, launched_kernels

    saved = {w: collections.Counter(w.form_launches)
             for w in (instance_norm_fwd, instance_norm_bwd)}
    try:
        before = launch_snapshot()
        instance_norm_bwd.form_launches["general", "f32"] += 2
        instance_norm_bwd.form_launches["general", "bf16"] += 1
        instance_norm_bwd.form_launches["warp", "bf16"] += 1
        instance_norm_bwd.form_launches["split", "f32"] += 1
        instance_norm_fwd.form_launches["general", "f32"] += 1
        assert launched_kernels(before) == collections.Counter(
            {"instance_norm_bwd_any": 3, "instance_norm_bwd_warp": 1,
             "instance_norm_split_bwd_stats": 1, "instance_norm_split_bwd": 1,
             "instance_norm_bwd_reduce": 2, "instance_norm_fwd_any": 1})
    finally:
        for w, counts in saved.items():
            w.form_launches.clear()
            w.form_launches.update(counts)

def test_trace_categories():
    cat = profile_trace.category
    assert cat("void rasterize_tiles_kernel<9>(...)") == "K1"
    assert cat("void instance_norm_fwd_kernel<float>(...)") == "K2"
    assert cat("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32") == \
        "convolution"
    assert cat("nvjet_tst_128x64_64x8_1x2_h_bz_TNT") == "gemm"
    assert cat("void at::native::elementwise_kernel<128, 4, "
               "direct_copy_kernel_cuda>") == "copy"
    assert cat("void cudnn::engines_precompiled::nchwToNhwcKernel") == "copy"
    assert cat("void at::native::index_elementwise_kernel<...>") == "index"
    assert cat("void at::native::reduce_kernel<512, 1, ...>") == "reduction"
    assert cat("void at::native::vectorized_elementwise_kernel<4, ...>") == \
        "elementwise"
    assert cat("aten::mkldnn_convolution") == "convolution"
    assert cat("aten::bmm") == "gemm"
    assert cat("aten::mul") == "elementwise"
    assert cat("Memcpy DtoD (Device -> Device)") == "copy"


JAX_TRACE_CONFIG = """
import dataclasses, json, sys
sys.path.insert(0, "tools")
import scflow_tpu.utils.cache as cache
cache.enable_compilation_cache = lambda *a, **k: None   # no cache here
import profile_trace
import scflow_tpu.training as jt

class Built(Exception):
    pass

def capture(cfg):
    raise Built(cfg)

jt.build_model = capture
try:
    profile_trace.build_step(2, "eval")
except Built as e:
    print(json.dumps(dataclasses.asdict(e.args[0])))
"""


def test_trace_config_is_jax_tools():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    done = subprocess.run([sys.executable, "-c", JAX_TRACE_CONFIG],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    jax_cfg = json.loads(done.stdout.strip().splitlines()[-1])
    _, cfg = profile_trace.build_step(1, "eval", device="cpu")
    assert_same_config(cfg, jax_cfg)


# -- the pose graph -----------------------------------------------------

MATMULS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
           "matmul", "linear", "einsum"}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def test_pose_graph_products_dispatch_no_matmul():
    from scflow_torch.parallel import pose_graph as pg

    g = torch.Generator().manual_seed(0)
    n, p = 3, 64
    points = torch.randn(n, p, 3, generator=g) * 30
    r = torch.linalg.qr(torch.randn(n, 3, 3, generator=g))[0]
    t = torch.tensor([[0.0, 0.0, 600.0]]).expand(n, 3)
    k = torch.tensor([[500.0, 0, 32], [0, 500.0, 32], [0, 0, 1]]
                     ).expand(n, 3, 3)
    w = torch.rand(n, p, generator=g)
    with _Ops() as ops:
        pg._object_jacobian(points, r, t, k, w)
        pg._residuals(points, torch.rand(n, p, 2, generator=g), r, t, k, w)
        pg._compose(torch.randn(n, 6, generator=g) * 1e-2, r, t)
    assert "mul" in ops.names and not ops.names & MATMULS, ops.names
