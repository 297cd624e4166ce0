"""The traced run's yardstick where a trace is taken again: K1's bound
counts the renders of the kept try alone, as K1's time does."""
import torch

from conftest import shrink

from portbench.core import cell, inputs, spec, trace
from portbench.yardstick import peaks, work

REFINE = "scflow-ycbv.refine-b32"
CARD = "NVIDIA H100 80GB HBM3"


class _Program:
    """A step that answers with zeros and records the batches it got."""

    def __init__(self):
        self.served = []

    def step(self, batch):
        self.served.append(batch)
        n = batch["labels"].shape[0]
        return {"rotations": torch.eye(3).expand(n, 3, 3),
                "translations": torch.zeros(n, 3)}


def test_k1_bound_counts_only_the_kept_trace(monkeypatch):
    man = spec.manifest()
    entry = spec.workload(man, REFINE)
    cfg, traffic = spec.config(man, entry["config"]), spec.traffic(
        entry["traffic"])
    shrink(cfg, traffic)
    traffic["pool"] = 3
    dev = torch.device("cpu")
    tables = inputs.mesh_tables(inputs.make_meshes(cfg, 5, dev))
    pool = inputs.make_pool(cfg, traffic, tables, 5, dev)
    program, feed = _Program(), cell.Feed(pool)
    k = traffic["trace_steps"]

    def profile(fn, steps, layer_mode=None):
        for _ in range(steps):
            fn()
        return [], 1.0, None

    verdicts = iter([False, True, True])    # the plain trace is retaken
    monkeypatch.setattr(trace, "_profile", profile)
    monkeypatch.setattr(trace, "_complete", lambda *a: next(verdicts))
    monkeypatch.setattr(trace, "summarize_plain",
                        lambda events, wall, steps: {"steps": steps})
    monkeypatch.setattr(trace, "layer_times",
                        lambda prof, events: {"render": 1.0})
    monkeypatch.setattr(cell, "launch_counts", lambda: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: CARD)
    out = cell._trace(program, feed, cfg, traffic, tables, dev)

    assert len(program.served) == 3 * k     # two plain tries, one layer
    peak = peaks.peaks(CARD)

    def bound(batches):
        return sum(work.bound_seconds(work.render_work(
            tables, b, cfg["image_size"]), peak) for b in batches)

    kept_try = program.served[k:2 * k]
    assert out["k1_bound_s"] == bound(kept_try)
    assert out["k1_bound_s"] < 0.75 * bound(program.served[:2 * k])
