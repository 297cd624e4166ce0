"""Spans of one cell on the card: the cost of the port's spans and where
the host is while the device works or idles.

    python3 portbench/span_trace.py --workload <cell> --seed <n>
        [--seconds 10] [--turns 2] [--plain 1]

After the cell's set-up (inputs and weights from the seed, the port's
step, warm-up or the checked train steps, as ``core/cell.py`` does; no
reference check), in one process: closed-loop windows of ``--seconds``
with spans off and on in turns (off, on, on, off, ...), each a rate in
objects or samples a second (``--turns 0``: none); a plain trace of
``trace_steps`` steps with spans off (``core/trace.py``: launches a
step, the traced window's wall time, the device's idle share; ``--plain
0``: none); and a span trace of as many steps (``core/spans.py``). The
per-span table goes to standard error; the last line of standard output
is one JSON object: ``card``, ``rates``, ``plain``, ``spans`` (the
summary), ``metrics`` and ``accounting``.
A traced benchmark run takes its span trace through this script with
``--turns 0 --plain 0`` (``core/spans.py``'s ``of``)."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ.setdefault(var, os.path.join(CACHE, sub))
sys.path.insert(0, ROOT)


class Cell:
    """A cell's port step after its set-up: ``one()`` is one traced step
    as ``cell._trace`` takes it (eval: the poses copied to the host)."""

    def __init__(self, name: str, seed: int, device: str = "cuda",
                 edit=None):
        import torch

        from portbench.core import cell, inputs, spec
        from portbench.core.program import Program
        from portbench.reference import steps as ref_steps

        man = spec.manifest()
        entry = spec.workload(man, name)
        cfg = spec.config(man, entry["config"])
        self.traffic = spec.traffic(entry["traffic"])
        if edit is not None:
            edit(cfg, self.traffic)
        cell._precision(cfg)
        self.dev = torch.device(device)
        meshes = inputs.make_meshes(cfg, seed, self.dev)
        tables = inputs.mesh_tables(meshes)
        shell = ref_steps.build_model(cfg["model"], cfg["image_size"], "meta")
        weights = inputs.make_weights(shell, seed, self.dev)
        points = inputs.make_points(cfg, meshes, seed, self.dev)
        pool = inputs.make_pool(cfg, self.traffic, tables, seed, self.dev)
        self.program = Program(cfg, self.traffic, meshes, weights, points,
                               self.dev)
        self.feed = cell.Feed(pool)
        self.train = self.traffic["step"] == "train"
        warm = self.traffic["checked_steps" if self.train
                            else "warmup_steps"]
        for _ in range(warm):
            self.one()
        self.sync()

    def sync(self) -> None:
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def one(self) -> None:
        out = self.program.step(self.feed.next()[1])
        if not self.train:
            out["rotations"].cpu()
            out["translations"].cpu()

    def window(self, seconds: float) -> float:
        """Objects or samples a second over a closed loop of ``seconds``
        that ends in a synchronise."""
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.one()
            n += 1
        self.sync()
        return n * self.traffic["batch"] / (time.perf_counter() - t0)


def rates(c: Cell, seconds: float, turns: int, enable) -> dict:
    """Window rates with spans off and on, in turns (off, on, on, off,
    ...); spans are off after it."""
    out = {"off": [], "on": []}
    try:
        for turn in range(turns):
            for flag in (False, True) if turn % 2 == 0 else (True, False):
                enable(flag)
                out["on" if flag else "off"].append(c.window(seconds))
    finally:
        enable(False)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--plain", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("span_trace: needs a CUDA card", file=sys.stderr)
        return 2
    from scflow_torch.utils.profiling import enable_spans

    from portbench.core import spans, trace
    from portbench.core.program import launch_counts

    c = Cell(args.workload, args.seed)
    setup_s = time.perf_counter() - T_START
    measured = rates(c, args.seconds, args.turns, enable_spans)
    k = c.traffic["trace_steps"]
    plain = None
    if args.plain:
        events, wall, _ = trace.take(c.one, k, launch_counts)
        p = trace.summarize_plain(events, wall, k)
        del events
        plain = {"launches_per_step": p["launches"] / k,
                 "wall_ms_per_step": 1e3 * wall / k,
                 "idle_pct": 100.0 * (1.0 - p["busy_s"] / p["window_s"])}
    summary = spans.take(c.one, k, launch_counts, enable_spans)
    out = {"cell": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(0), "setup_s": setup_s,
           "seconds": args.seconds, "rates": measured, "plain": plain,
           "spans": summary, "metrics": spans.metrics(summary),
           "accounting": spans.accounting(summary)}
    print(f"{args.workload} seed {args.seed}, {k} steps, scopes "
          f"{summary['scopes']}:\n{spans.table(summary)}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
