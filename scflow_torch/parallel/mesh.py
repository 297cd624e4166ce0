"""The process group of a multi-process run (port of
``scflow_tpu/parallel/mesh.py``). The JAX package builds a device mesh
with a ``data`` axis and lets XLA insert the collectives; the port runs
one process per device with ``torch.distributed`` (NCCL on CUDA, gloo on
the CPU) and makes them itself. A process may build the same global
batch as every other from the same seed and keep its rank's contiguous
slice (:func:`shard_batch`), the slice ``NamedSharding(P("data"))`` gives
a process in JAX; the training CLI's disk loader builds only its share
instead.
"""
from __future__ import annotations

import os
import queue
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device: str | torch.device = "cuda"
                           ) -> torch.device:
    """Join the process group; returns this process's device.

    The arguments default to the JAX package's variables:
    ``SCFLOW_NUM_PROCESSES``, ``SCFLOW_COORDINATOR`` (host:port, default
    127.0.0.1:9999, rank 0 listens there) and ``SCFLOW_PROCESS_ID``. As in
    JAX, a run of one process (no count, or a count of 1) starts nothing.
    On ``device="cuda"`` the group is NCCL and rank r takes
    ``cuda:{r % device_count}``; on the CPU it is gloo."""
    dev = resolve_device(device)
    if num_processes is None:
        num_processes = int(os.environ.get("SCFLOW_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return dev
    if process_id is None:
        process_id = int(os.environ.get("SCFLOW_PROCESS_ID", "0"))
    address = coordinator_address or os.environ.get("SCFLOW_COORDINATOR",
                                                    "127.0.0.1:9999")
    return _join(address, num_processes, process_id, dev)


def _join(address: str, world: int, rank_: int,
          dev: torch.device) -> torch.device:
    """Start this process's part of a group of ``world`` at ``address``."""
    if dev.type == "cuda":
        dev = torch.device("cuda", rank_ % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{address}",
                            world_size=world, rank=rank_)
    return dev


def is_distributed() -> bool:
    """Whether a process group is up (the steps then run data-parallel)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def shard_batch(batch: dict) -> dict:
    """This rank's contiguous slice of every entry's leading (batch) axis;
    the batch must divide by the world size. Without a group, the batch."""
    world = world_size()
    if world == 1:
        return batch
    r = rank()
    out = {}
    for key, v in batch.items():
        n = v.shape[0]
        if n % world:
            raise ValueError(f"batch entry {key!r} of {n} does not divide "
                             f"over {world} processes")
        part = n // world
        out[key] = v[r * part:(r + 1) * part]
        if isinstance(v, np.ndarray):
            out[key] = np.ascontiguousarray(out[key])
        elif isinstance(v, torch.Tensor):
            out[key] = out[key].contiguous()
    return out


def _rank_main(rank_: int, fn, world: int, address: str, device: str,
               args: tuple, results) -> None:
    if torch.device(device).type == "cpu":
        # the ranks share the host's cores (OMP_NUM_THREADS, else all)
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    _join(address, world, rank_, resolve_device(device))
    try:
        results.put((rank_, fn(*args)))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args: tuple = (), device: str = "cpu",
          timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` in ``world`` new processes (spawned, so ``fn``
    must be importable by name) joined into one process group on a free
    local port, even a group of one; returns their results by rank. A
    process that raises makes this raise."""
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{s.getsockname()[1]}"
    results = mp.get_context("spawn").Queue()
    procs = mp.start_processes(
        _rank_main, args=(fn, world, address, device, args, results),
        nprocs=world, join=False, start_method="spawn")
    got = {}
    t_end = time.monotonic() + timeout
    try:
        while len(got) < world:
            try:
                r, value = results.get(timeout=1.0)
                got[r] = value
            except queue.Empty:
                # join raises the exception of a process that failed
                if procs.join(timeout=0) or time.monotonic() > t_end:
                    raise RuntimeError(f"spawn: results of ranks "
                                       f"{sorted(got)} of {world}") from None
        procs.join(timeout=max(t_end - time.monotonic(), 1.0))
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
                p.join()
    return [got[r] for r in range(world)]
