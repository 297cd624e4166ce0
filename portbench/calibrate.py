"""Readings that the limits of ``correct`` are set from, on the card.

For each seed, in one process: a short run of the cell (the port's
timed path against the plain reference, as every run compares it), then
the control, the reference in the program's place computed in TF32 (the
precision below float32 without TF32), held against the reference by the
same numbers; for train cells also the planted fault of half the batch
left out (the mean taken over the rest). A state left unchanged reads 1
on ``change_leaf`` by that number's definition and needs no run.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3
        [--seconds 2] [--out FILE]

Each seed prints one JSON line: {seed, program, control[, half]}."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def control_numbers(record: dict, device) -> dict:
    """{control[, half]}: numbers of the reference in TF32 (and of the
    half-batch fault) against the float32 reference of the run."""
    import torch

    from portbench.core import check
    from portbench.reference import steps as ref_steps

    k = record["kept"]
    cfg, traffic, pool = k["cfg"], k["traffic"], k["pool"]
    out = {}

    def model():
        m = ref_steps.build_model(cfg["model"], cfg["image_size"], device)
        m.load_state_dict(k["weights"])
        return m

    def tf32(on: bool):
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on

    if traffic["step"] == "train":
        fed = [pool[i % len(pool)] for i in range(traffic["checked_steps"])]
        tf32(True)
        control = ref_steps.train_steps(model(), k["tables"], k["points"],
                                        fed, cfg)
        tf32(False)
        out["control"] = check.train_numbers(control, k["ref"], k["weights"])
        half = ref_steps.train_steps(model(), k["tables"], k["points"], fed,
                                     cfg, drop_half=True)
        out["half"] = check.train_numbers(half, k["ref"], k["weights"])
        return out
    tf32(True)
    m = model()
    poses, kept, stages = {}, {}, {}
    for b in k["ref"]:
        o = ref_steps.eval_step(m, k["tables"], pool[b], cfg,
                                stages if b == k["stage_id"] else None)
        poses[b] = [(o["rotations"].cpu(), o["translations"].cpu())]
        if b in k["kept_ids"]:
            kept[b] = o
    tf32(False)
    pnp = None
    if cfg["model"]["family"] in ref_steps.RAFT_FAMILIES:
        pnp = {b: ref_steps.pnp_leg(o["flow"], o["masks"], o["depth"],
                                    pool[b], cfg) for b, o in kept.items()}
    out["control"] = check.eval_numbers(poses, kept, stages, k["ref"],
                                        k["ref_stages"], pnp)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from portbench.core import cell

    lines = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        record = cell.run(args.workload, seed, args.seconds, False, t0,
                          keep=True)
        line = {"seed": seed, "program": record["numbers"],
                **control_numbers(record, torch.device("cuda")),
                "setup_s": record["setup_s"], "steps": record["steps"],
                "seconds": time.perf_counter() - t0}
        del record
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
