"""BENCHMARK.json against the shapes a manifest takes, and every cell's files
found by name."""
import json
import os
import re

import pytest

from portbench.core import spec

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
MAN = spec.manifest()


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_unique_and_well_formed(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.fullmatch(n), n


@pytest.mark.parametrize("metric", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.fullmatch(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in MAN["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    assert os.path.isfile(os.path.join(spec.HERE, "metrics",
                                       metric["name"] + ".py"))
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        moves = {m["name"]: m for m in MAN["end_to_end"]}[metric["moves"]]
        # every cell that lists the metric reports the metric it moves
        assert set(metric["workloads"]) <= set(moves.get("workloads",
                                                         cells))
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200
        if "_roofline" in metric["name"] or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(cell):
    assert cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200
    cfg = spec.config(MAN, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(cell["name"])
    assert traffic["step"] in ("eval", "train")
    assert limits and all(v is not None for v in limits.values())
    assert cfg["precision"] == {"dtype": "float32", "tf32": False}
    reported = {m["name"] for m in spec.metrics(MAN, cell["name"],
                                                 "end_to_end")}
    assert "setup_s" in reported and len(reported) >= 2
    assert spec.metrics(MAN, cell["name"], "per_layer")


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_configs_used_and_listed(entry):
    assert any(w["config"] == entry["name"] for w in MAN["workloads"])
    assert entry["file"].startswith("portbench/configs/")
    cfg = spec.config(MAN, entry["name"])
    assert cfg["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
    assert entry["source"] == cfg["source"]
