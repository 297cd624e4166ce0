"""Communication-layer microbenchmark (port of ``tools/comm_bench.py``).

Measures (a) the gradient all-reduce's bandwidth over the process group
and (b) the data-parallel train step's weak-scaling efficiency against a
one-process run. The JAX tool psums over a device mesh (``--cpu N``
virtual CPU devices); the port runs one process per device
(``parallel.mesh.spawn``): ``--world N`` gloo ranks on the CPU, and on
the card one NCCL rank per card (``--world`` may not exceed the cards:
one card gives world 1, whose all-reduce moves no bytes, so its bus
bandwidth is 0, as in JAX). Prints one JSON line per measurement with the
JAX tool's names and units: ``mesh_devices``, ``psum_allreduce_busbw`` per
payload (GB/s, beside ``latency_ms``), ``dp_weak_scaling_efficiency``
(beside ``t_1dev_ms`` and ``t_ndev_ms``, and rank 0's K1 and K2
launches in the n-rank run).

  python -m scflow_torch.tools.comm_bench [--device cpu] [--world N]
      [--sizes-mb 1 8 64] [--batch-per-device 2] [--image-size 64]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from ..device import resolve_device, synchronize

REPS, DP_STEPS = 10, 5


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--world", type=int, default=None,
                   help="processes (CPU: gloo ranks; CUDA: at most the "
                        "cards, default all of them)")
    p.add_argument("--sizes-mb", type=float, nargs="+",
                   default=[1.0, 8.0, 64.0])
    p.add_argument("--batch-per-device", type=int, default=2)
    p.add_argument("--image-size", type=int, default=64)
    return p.parse_args(argv)


def _slowest(seconds: float, dev: torch.device) -> float:
    """The largest of the ranks' ``seconds``."""
    import torch.distributed as dist

    t = torch.tensor([seconds], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.item()


def allreduce_rank(sizes_mb: list, device: str) -> list:
    """One rank's part of the all-reduce measurement: for each payload, an
    f32 tensor of integer values, all-reduced once and checked against
    world × its values exactly, then 10 in-place all-reduces timed from a
    barrier to a device sync; returns (payload MB, the slowest rank's
    seconds per all-reduce) per payload."""
    import torch.distributed as dist

    from ..parallel.mesh import world_size

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device("cpu"))
    n = world_size()
    out = []
    for size_mb in sizes_mb:
        elems = int(size_mb * 1e6 / 4)
        x = (torch.arange(elems, device=dev) % 7 + 1).float()
        buf = x.clone()
        dist.all_reduce(buf)
        synchronize(dev)
        if not torch.equal(buf, n * x):
            raise AssertionError(f"all-reduce of {size_mb} MB: not {n} × x")
        dist.barrier()
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(REPS):
            dist.all_reduce(buf)
        synchronize(dev)
        out.append((size_mb, _slowest((time.perf_counter() - t0) / REPS,
                                      dev)))
    return out


def dp_config(batch: int, image_size: int):
    """The JAX tool's train configuration for a global ``batch``."""
    from ..training import (Config, DataConfig, LossConfig, ModelConfig,
                            OptimConfig)

    return Config(model=ModelConfig(num_class=2, iters=2, test_iters=2),
                  loss=LossConfig(num_loss_points=64),
                  optim=OptimConfig(total_steps=100),
                  data=DataConfig(batch_size=batch, image_scale=image_size))


def dp_step_rank(batch_per_device: int, image_size: int,
                 device: str) -> tuple:
    """One rank's part of a data-parallel train step at ``batch_per_device``
    × world samples: every rank builds the global synthetic batch from one
    seed and takes its slice; 1 warm-up and 5 timed steps; returns (the
    slowest rank's seconds per step, this rank's kernel launches from the
    batch's render to the last step)."""
    from ..data import synthetic_batch
    from ..ops import rasterize_fast as rf
    from ..ops.fused_norm import instance_norm_bwd, instance_norm_fwd
    from ..parallel.mesh import shard_batch, world_size
    from ..rendering import Renderer, make_test_meshes
    from ..training import build_model, build_points_bank, make_optimizer
    from ..training.steps import make_train_step

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device("cpu"))
    cfg = dp_config(batch_per_device * world_size(), image_size)
    bank = make_test_meshes(num_classes=2, subdivisions=1, radius=60.0,
                            device=dev)
    renderer = Renderer(bank, image_size=(image_size, image_size))
    points = build_points_bank(bank, num_points=64)
    # the JAX model takes its feature size from its first input; the
    # port's decoder is built for the frame (``RenderConfig.image_size``)
    model = build_model(dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, image_size=(image_size, image_size))), device=dev)
    step = make_train_step(model, renderer, points, cfg,
                           make_optimizer(cfg, model.parameters()),
                           device=dev)
    wrappers = (rf.rasterize_tiles, instance_norm_fwd, instance_norm_bwd)
    before = [w.launches for w in wrappers]
    batch = shard_batch(synthetic_batch(torch.Generator().manual_seed(0),
                                        renderer, cfg.data.batch_size))
    metrics = step(batch)
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(DP_STEPS):
        metrics = step(batch)
    synchronize(dev)
    dt = (time.perf_counter() - t0) / DP_STEPS
    if not all(bool(torch.isfinite(v).all()) for v in metrics.values()):
        raise AssertionError("DP train step: non-finite metrics")
    launches = {w.__name__: w.launches - b for w, b in zip(wrappers, before)}
    return _slowest(dt, dev), launches


def _measure(sizes_mb: list, batch_per_device: int, image_size: int,
             device: str) -> tuple:
    """A rank's work: the all-reduces, then the DP step."""
    return (allreduce_rank(sizes_mb, device),
            dp_step_rank(batch_per_device, image_size, device))


def main(argv=None) -> list:
    """Run the measurements; print and return the JSON lines."""
    args = parse_args(argv)
    from ..parallel.mesh import spawn

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        n = cards if args.world is None else args.world
        if not 0 < n <= cards:
            raise ValueError(f"--world {n}: {cards} card(s), one rank each")
    else:
        n = args.world or 1
    device = dev.type
    lines = [{"metric": "mesh_devices", "value": n, "unit": "devices",
              "platform": "gpu" if device == "cuda" else "cpu"}]
    print(json.dumps(lines[-1]), flush=True)
    work = (args.sizes_mb, args.batch_per_device, args.image_size, device)
    times, (tn, launches) = spawn(_measure, n, work, device=device)[0]
    for size_mb, dt in times:
        # ring all-reduce moves 2(n-1)/n of the payload per device
        algo_bytes = 2 * (n - 1) / n * int(size_mb * 1e6 / 4) * 4
        lines.append({"metric": "psum_allreduce_busbw", "payload_mb": size_mb,
                      "value": algo_bytes / dt / 1e9, "unit": "GB/s",
                      "latency_ms": dt * 1e3})
        print(json.dumps(lines[-1]), flush=True)
    t1 = (spawn(dp_step_rank, 1, work[1:], device=device)[0][0] if n > 1
          else tn)
    # perfect weak scaling: the same step time at n× the global batch
    eff = t1 / tn if n > 1 else 1.0
    lines.append({"metric": "dp_weak_scaling_efficiency", "devices": n,
                  "value": min(eff, 1.0), "unit": "ratio",
                  "t_1dev_ms": t1 * 1e3, "t_ndev_ms": tn * 1e3,
                  "rank0_launches": launches})
    print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
