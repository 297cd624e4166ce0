"""One run of one cell: set-up, the measured window, the traced steps
(``--trace 1``), the reference check, the metrics.

Set-up makes the inputs from the seed, builds the port's step through its
own entry points and drives it over the cell's shapes (eval: a few steps;
train: the checked first steps, which the reference follows); nothing
compiles after it. The window is a closed loop of one client for
``seconds``: eval steps each timed from dispatch until their poses are on
the host, train steps dispatched back to back; it ends in a synchronise.
The reference runs after the window, after the window's peak memory has
been read and the port's state freed."""
from __future__ import annotations

import gc
import time

import torch

from ..reference import steps as ref_steps
from . import check, inputs, spec, trace
from .program import Program, launch_counts, port_root

GIB = float(1 << 30)


def _precision(cfg: dict) -> None:
    p = cfg["precision"]
    if p["dtype"] != "float32":
        raise ValueError(f"precision {p['dtype']!r}: only float32 is built")
    torch.backends.cuda.matmul.allow_tf32 = p["tf32"]
    torch.backends.cudnn.allow_tf32 = p["tf32"]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Feed:
    """The closed loop's next batch: the pool in turn."""

    def __init__(self, pool: list, start: int = 0):
        self.pool, self.at = pool, start

    def next(self) -> tuple[int, dict]:
        b = self.at % len(self.pool)
        self.at += 1
        return b, self.pool[b]


def _port_train_state(program: Program) -> tuple[dict, dict]:
    """(the first gradient by name, from AdamW's first moment after one
    update; the parameters now), both copies."""
    beta1 = program.optimizer.param_groups[0]["betas"][0]
    grads, params = {}, {}
    for n, p in program.model.named_parameters():
        state = program.optimizer.state.get(p)
        if state:
            grads[n] = state["exp_avg"].detach() / (1.0 - beta1)
        params[n] = p.detach().clone()
    return grads, params


def run(cell: str, seed: int, seconds: float, traced: bool, t_start: float,
        device: str = "cuda", edit=None, break_step=None,
        keep: bool = False) -> dict:
    """The record of one run (see ``portbench/run.py``). ``edit(cfg,
    traffic)`` may shrink a cell for a CPU test; ``break_step(program)``
    plants a fault in the timed path for a test; ``keep`` leaves the
    inputs and the reference's results in the record (``kept``), for the
    controls of ``portbench/calibrate.py``."""
    man = spec.manifest()
    entry = spec.workload(man, cell)
    cfg, traffic = spec.config(man, entry["config"]), spec.traffic(
        entry["traffic"])
    if edit is not None:
        edit(cfg, traffic)
    _precision(cfg)
    dev = torch.device(device)
    is_train = traffic["step"] == "train"

    # set-up: inputs from the seed, the port's step, the cell's shapes
    meshes = inputs.make_meshes(cfg, seed, dev)
    tables = inputs.mesh_tables(meshes)
    shell = ref_steps.build_model(cfg["model"], cfg["image_size"], "meta")
    weights = inputs.make_weights(shell, seed, dev)
    points = inputs.make_points(cfg, meshes, seed, dev)
    pool = inputs.make_pool(cfg, traffic, tables, seed, dev)
    program = Program(cfg, traffic, meshes, weights, points, dev)
    if break_step is not None:
        break_step(program)
    feed = Feed(pool)
    port_train = None
    if is_train:
        losses = []
        for i in range(traffic["checked_steps"]):
            metrics = program.step(feed.next()[1])
            losses.append(metrics["loss"])
            if i == 0:
                first_grads, _ = _port_train_state(program)
        _, params = _port_train_state(program)
        port_train = {"losses": [float(v) for v in losses],
                      "first_grads": first_grads, "params": params}
    else:
        for _ in range(traffic["warmup_steps"]):
            program.step(feed.next()[1])["rotations"].cpu()
    _sync(dev)
    setup_s = time.perf_counter() - t_start

    # the window
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    step_s, poses, kept = [], {}, {}
    first = int(seed) % len(pool)
    kept_ids = {first, (first + 1 + int(seed) // len(pool) % max(
        len(pool) - 1, 1)) % len(pool)}
    n_steps = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        b, batch = feed.next()
        s0 = time.perf_counter()
        out = program.step(batch)
        if not is_train:
            pose = (out["rotations"].cpu(), out["translations"].cpu())
            step_s.append(time.perf_counter() - s0)
            poses.setdefault(b, []).append(pose)
            if b in kept_ids:
                kept[b] = out
        n_steps += 1
    _sync(dev)
    if not is_train and not kept:   # a window too short for the drawn two
        kept[b] = out
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
            else 0)
    record = {"cell": cell, "step": traffic["step"],
              "batch": traffic["batch"], "steps": n_steps,
              "window_s": window_s, "step_s": step_s, "setup_s": setup_s,
              "peak_bytes": peak, "trace": None}

    if traced:
        record["trace"] = _trace(program, feed, cfg, traffic, tables, dev)

    # the port's stages on one kept batch, by one more call of its step
    stages = {}
    if not is_train:
        b_stage = min(kept)

        def keep_render(module, args):
            stages["render_images"] = args[0]

        def keep_features(module, args, out):
            stages.setdefault("features", []).append(out)

        hooks = [program.model.register_forward_pre_hook(keep_render),
                 program.encoder().register_forward_hook(keep_features)]
        out = program.step(pool[b_stage])
        stages["render_depth"] = out["depth"]
        for h in hooks:
            h.remove()
    del program
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, on the same inputs and weights
    model = ref_steps.build_model(cfg["model"], cfg["image_size"], dev)
    model.load_state_dict(weights)
    if is_train:
        fed = [pool[i % len(pool)] for i in range(traffic["checked_steps"])]
        ref = ref_steps.train_steps(model, tables, points, fed, cfg)
        numbers = check.train_numbers(port_train, ref, weights)
    else:
        # SCFlow: every batch the window served, for its steps' poses;
        # RAFT: the kept batches, whose flow the PnP leg is judged on
        raft = cfg["model"]["family"] in ref_steps.RAFT_FAMILIES
        ref, ref_stages = {}, {}
        for b in (kept if raft else poses):
            ref[b] = ref_steps.eval_step(
                model, tables, pool[b], cfg,
                ref_stages if b == b_stage else None)
        pnp = None
        if raft:
            with torch.no_grad():
                pnp = {b: ref_steps.pnp_leg(o["flow"], o["masks"], o["depth"],
                                            pool[b], cfg)
                       if o["flow"].shape[0] == pool[b]["labels"].shape[0]
                       else None for b, o in kept.items()}
        numbers = check.eval_numbers(poses, kept, stages, ref, ref_stages,
                                     pnp)
    record["numbers"] = numbers
    if keep:
        record["kept"] = dict(cfg=cfg, traffic=traffic, tables=tables,
                              weights=weights, points=points, pool=pool,
                              ref=ref, kept_ids=sorted(kept),
                              stage_id=None if is_train else b_stage,
                              ref_stages=None if is_train else ref_stages)
    return record


def _trace(program, feed, cfg, traffic, tables, dev) -> dict:
    """The two traces of ``trace_steps`` steps and the bounds and FLOPs
    their readers divide by."""
    from ..yardstick import flops, peaks, work

    k = traffic["trace_steps"]
    used = []

    def one():
        b, batch = feed.next()
        used.append(b)
        out = program.step(batch)
        if traffic["step"] != "train":
            out["rotations"].cpu()
            out["translations"].cpu()

    # the K1 bound counts the renders of the kept try alone
    events, wall, _ = trace.take(one, k, launch_counts, reset=used.clear)
    plain = trace.summarize_plain(events, wall, k)
    del events
    plain_batches = list(used)
    events, _, prof = trace.take(one, k, launch_counts,
                                 trace.LayerRanges(port_root()))
    by_layer = trace.layer_times(prof, events)
    del events, prof
    total = sum(by_layer.values())
    unattributed = by_layer.get(trace.UNATTRIBUTED, 0.0) / total
    if unattributed > trace.MAX_UNATTRIBUTED:
        raise RuntimeError(f"{100 * unattributed:.2f}% of kernel time under "
                           f"no layer (the limit is "
                           f"{100 * trace.MAX_UNATTRIBUTED}%)")
    peak = peaks.peaks(torch.cuda.get_device_name(dev))
    counted = flops.count_step(cfg, traffic)
    k1_bound = sum(work.bound_seconds(work.render_work(
        tables, feed.pool[b], cfg["image_size"]), peak)
        for b in plain_batches)
    k2_bound = 0.0
    for shape in counted["norm_shapes"]:
        k2_bound += work.bound_seconds(work.norm_work(shape, 4, False), peak)
        if counted["backward"]:
            k2_bound += work.bound_seconds(work.norm_work(shape, 4, True),
                                           peak)
    return {"plain": plain, "layers_us": by_layer, "layer_steps": k,
            "unattributed": unattributed, "flops_per_step": counted["flops"],
            "peak_flops": peak["float32"], "k1_bound_s": k1_bound,
            "k2_bound_s": k2_bound * k}
