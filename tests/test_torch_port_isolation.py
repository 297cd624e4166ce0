"""The PyTorch port stands alone: no JAX, no scflow_tpu, no silent CPU.

Every module of ``scflow_torch`` and ``chip_smoke`` must import in a
process where ``jax``, ``flax``, ``optax``, ``scflow_tpu``, ``cv2`` and
``PIL`` cannot be imported (a GPU host may have neither cv2 nor PIL),
and every entry point must refuse ``device="cuda"`` when there is no GPU
instead of falling back to the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "scflow_tpu", "cv2", "PIL")

IMPORT_ALL = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None        # any import of it now raises
import scflow_torch
names = [m.name for m in pkgutil.walk_packages(scflow_torch.__path__,
                                               "scflow_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20      # every module was reached


def _port_sources():
    return sorted(p.relative_to(REPO).as_posix()
                  for p in [*REPO.joinpath("scflow_torch").rglob("*.py"),
                            REPO / "chip_smoke.py"])


@pytest.mark.parametrize("path", _port_sources())
def test_no_jax_import_in_source(path):
    text = (REPO / path).read_text()
    pattern = r"^\s*(import|from)\s+(%s)\b" % "|".join(BLOCKED)
    assert not re.search(pattern, text, re.M), path


def test_entry_points_refuse_missing_gpu(monkeypatch, tmp_path):
    from scflow_torch.rendering import (Renderer, load_mesh_dir,
                                        make_test_meshes)
    from scflow_torch.test import main as test_main
    from scflow_torch.tools.make_synthetic_bop import main as make_bop
    from scflow_torch.training import (Config, ModelConfig, RenderConfig,
                                       build_model, build_points_bank,
                                       make_eval_step,
                                       make_multi_cycle_train_step,
                                       make_multi_pass_eval_step,
                                       make_optimizer, make_panel_step,
                                       make_train_step)
    from scflow_torch.train import main
    from scflow_torch.training.trainer import Trainer

    cfg = Config(model=ModelConfig(num_class=2),
                 render=RenderConfig(image_size=(64, 64)))
    raft_cfg = Config(model=ModelConfig(family="raft_flow_mask", iters=2),
                      render=RenderConfig(image_size=(64, 64)))
    model = build_model(cfg, device="cpu")
    raft = build_model(raft_cfg, device="cpu")
    bank = make_test_meshes(2, subdivisions=1, device="cpu")
    renderer = Renderer(bank, image_size=(64, 64))
    points = build_points_bank(bank, num_points=8)
    opt = make_optimizer(cfg, model.parameters())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: make_eval_step(model, renderer, cfg),
                 lambda: make_eval_step(model, renderer, cfg, device="cuda"),
                 lambda: make_multi_pass_eval_step(model, renderer, cfg),
                 lambda: make_train_step(model, renderer, points, cfg, opt),
                 lambda: make_multi_cycle_train_step(model, renderer, points,
                                                     cfg, opt),
                 lambda: build_model(cfg),
                 lambda: build_model(raft_cfg),
                 lambda: make_eval_step(raft, renderer, raft_cfg),
                 lambda: make_train_step(raft, renderer, points, raft_cfg,
                                         opt),
                 lambda: make_test_meshes(2, subdivisions=1),
                 lambda: make_panel_step(model, renderer, cfg),
                 lambda: Trainer(cfg, renderer, points),
                 lambda: Trainer(cfg, renderer, points, device="cuda:0"),
                 lambda: main(["--synthetic", "--steps", "1",
                               "--image-size", "64", "--num-classes", "2"]),
                 lambda: load_mesh_dir(str(tmp_path)),
                 lambda: test_main(["--data-root", "d", "--ref-annots-root",
                                    "r", "--image-list", "l", "--mesh-dir",
                                    str(tmp_path)]),
                 lambda: make_bop(["--out", str(tmp_path / "bop")])):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()
    assert next(model.parameters()).device.type == "cpu"
    assert next(raft.parameters()).device.type == "cpu"
    assert not (tmp_path / "bop").exists()      # refused before writing
