"""Where a run finds what it runs, by the names in ``BENCHMARK.json``: a
cell's configuration file (the manifest's ``file``), its traffic mix
(``traffic/<traffic>.json``), its limits (``workloads/<cell>.json``) and
each metric's reader (``metrics/<metric>.py``, a ``read(record)`` that
returns a number, or None where the record holds nothing to read)."""
from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def _named(name: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def manifest() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(man: dict, name: str) -> dict:
    for entry in man["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(man: dict, name: str) -> dict:
    for entry in man["configs"]:
        if entry["name"] == name:
            return _json(os.path.join(ROOT, entry["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json(os.path.join(HERE, "traffic", _named(name) + ".json"))


def limits(cell: str) -> dict:
    return _json(os.path.join(HERE, "workloads",
                              _named(cell) + ".json"))["limits"]


def metrics(man: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports."""
    return [m for m in man[kind] if cell in m.get("workloads", [cell])]


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", _named(metric) + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", metric), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
