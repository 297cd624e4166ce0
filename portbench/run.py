"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; its last key, ``checks``, holds every number compared
with its limit, which also end standard error. The run exits non-zero,
printing no result, without as many CUDA cards as the cell asks for,
when the port is missing, or when JAX or the JAX package is loaded after
the window. Every cache it or the port writes lies inside the checkout."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.path.insert(0, ROOT)

# the top-level modules that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "scflow_tpu")


def forbidden_modules() -> list:
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result(record: dict, traced: bool, man: dict, limits: dict,
           card: str) -> dict:
    """The result line of a run's record on the card named ``card``."""
    from portbench.core import check, spec

    correct, checks = check.verdict(record["numbers"], limits)
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in spec.metrics(man, record["cell"], kind):
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": card,
              "count": 1, "memory_peak_bytes": record["peak_bytes"]}
    out = {"correct": correct,
           "attempted": record["steps"] * record["batch"], "failed": 0,
           "metrics": metrics, "device": device}
    if traced:
        plain = record["trace"]["plain"]
        device.update(busy_s=plain["busy_s"], window_s=plain["window_s"])
        out["breakdown"] = {"device_ops": plain["device_ops"],
                            "idle_gaps": plain["idle_gaps"]}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from portbench.core import spec

    man = spec.manifest()
    chips = spec.workload(man, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    limits = spec.limits(args.workload)
    from portbench.core import cell

    record = cell.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: JAX or the JAX package was loaded: {loaded}",
              file=sys.stderr)
        return 3
    out = result(record, bool(args.trace), man, limits,
                 torch.cuda.get_device_name(0))
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:           # the traceback before the exit, no result
        traceback.print_exc()
        code = 1
    sys.exit(code)
