"""A configuration, a cell and a per-layer metric added as files and
manifest entries alone are picked up by the harness, unedited."""
import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

SCRIPT = r"""
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import importlib.util
spec_ = importlib.util.spec_from_file_location("run", sys.argv[1] + "/portbench/run.py")
run = importlib.util.module_from_spec(spec_); spec_.loader.exec_module(run)
from portbench.core import cell, spec
from conftest import shrink
assert spec.ROOT == sys.argv[1], spec.ROOT
man = spec.manifest()
for traced in (False,):
    rec = cell.run("scflow-ycbv-wide.refine-b4", 5, 0.5, traced,
                   time.perf_counter(), device="cpu", edit=shrink)
    rec["peak_bytes"] = 1
    out = run.result(rec, traced, man, spec.limits("scflow-ycbv-wide.refine-b4"), "cpu")
    print(json.dumps(out))
"""


def test_added_files_are_picked_up(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    bench = root / "portbench"
    cfg = json.loads((bench / "configs" / "scflow-ycbv.json").read_text())
    cfg["model"]["radius"] = 3
    (bench / "configs" / "scflow-ycbv-wide.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "refine-b32.json").read_text())
    traffic["batch"] = 4
    (bench / "traffic" / "refine-b4.json").write_text(json.dumps(traffic))
    limits = json.loads((bench / "workloads" /
                         "scflow-ycbv.refine-b32.json").read_text())
    (bench / "workloads" / "scflow-ycbv-wide.refine-b4.json").write_text(
        json.dumps(limits))
    (bench / "metrics" / "objects_per_step.py").write_text(
        "def read(rec):\n    return float(rec['batch'])\n")
    man["configs"].append(dict(man["configs"][0], name="scflow-ycbv-wide",
                               file="portbench/configs/scflow-ycbv-wide.json",
                               reduced=["mesh", "radius"]))
    man["workloads"].append(dict(man["workloads"][0],
                                 name="scflow-ycbv-wide.refine-b4",
                                 config="scflow-ycbv-wide",
                                 traffic="refine-b4"))
    man["end_to_end"].append({"name": "objects_per_step", "unit": "objects",
                              "better": "higher", "bound": 0.01,
                              "source": "host_clock",
                              "workloads": ["scflow-ycbv-wide.refine-b4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(root), os.path.dirname(
            os.path.abspath(__file__)), ROOT],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(root), os.path.dirname(os.path.abspath(__file__)), ROOT])))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["metrics"]["objects_per_step"]["value"] == 2.0
    assert "refine_objects_per_s" not in out["metrics"]
    assert out["correct"] is True, out["checks"]
