"""What a run loads: never JAX or the JAX package; the reference loads
nothing of the port; a directory with the benchmark alone runs nothing."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "scflow_tpu")
REFERENCE = ["portbench.reference.steps", "portbench.reference.losses",
             "portbench.reference.models.refiner",
             "portbench.reference.models.flow_pose",
             "portbench.reference.rendering.renderer",
             "portbench.yardstick.work", "portbench.yardstick.flops",
             "portbench.yardstick.peaks"]


def _loaded(code: str) -> set:
    proc = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.', 1)[0] for m in "
         "sys.modules})))"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("module", REFERENCE)
def test_reference_loads_nothing_of_the_port(module):
    top = _loaded(f"import {module}")
    assert not top & {"scflow_torch", *FORBIDDEN}


def test_a_run_loads_no_jax():
    top = _loaded(
        "import time, sys\nsys.path.insert(0, 'portbench/tests')\n"
        "from conftest import shrink\n"
        "import portbench.run\n"
        "from portbench.core import cell\n"
        "for c in ('scflow-ycbv.refine-b32', 'raft-ycbv.train-b16'):\n"
        "    cell.run(c, 3, 0.2, False, time.perf_counter(), device='cpu',"
        " edit=shrink)\n")
    assert "scflow_torch" in top
    assert not top & set(FORBIDDEN)


def test_forbidden_names_compare_whole_top_level_names():
    sys.path.insert(0, ROOT)
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "pb_run", os.path.join(ROOT, "portbench", "run.py"))
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    before = dict(sys.modules)
    try:
        sys.modules.pop("jax", None)
        assert "scflow_torch" not in run.forbidden_modules()
        sys.modules["scflow_tpu.fake"] = object()
        assert run.forbidden_modules() == ["scflow_tpu.fake"]
    finally:
        sys.modules.clear()
        sys.modules.update(before)


def test_benchmark_alone_runs_nothing(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "scflow-ycbv.refine-b32", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env={k: v for k, v in os.environ.items()
                           if k != "PYTHONPATH"})
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
