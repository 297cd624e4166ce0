"""The port's BOP eval loop and its CLI against the JAX package's, on the
CPU.

One tree written by the port's ``make_synthetic_bop`` (160² frames, 3
classes, 6 images of 1–3 objects); 64² crops, 2 GRU iterations, 1000
metric points per class, ``slot_budget=4``, so packing spans several
batches and flushes images that do not fit. The weights are the port's
seeded init with ``perturb``'s noise, bridged into both packages; JAX
renders with the Pallas tile rasterizer in interpret mode and crops with
its C++ library (``native_crop="on"``), as the port's one crop path does.
"""
import contextlib
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_common import perturb
from port_common import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
NUM_CLASS = 3
CROP = 64
ITERS = 2
BUDGET = 4
IMAGES = 6
ROT_ATOL, TRANS_RTOL, TRANS_ATOL = 2e-3, 2e-3, 2e-4


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from scflow_torch.tools.make_synthetic_bop import main

    out = tmp_path_factory.mktemp("bop")
    counts = main(["--out", str(out), "--num-images", str(IMAGES),
                   "--num-classes", str(NUM_CLASS), "--height", "160",
                   "--width", "160", "--max-objects", "3", "--seed", "5",
                   "--device", "cpu"])
    return out, counts


def _paths(out) -> dict:
    return dict(data_root=str(out / "test"),
                ref_annots_root=str(out / "init_poses"),
                image_list=str(out / "image_lists" / "test.txt"),
                mesh_dir=str(out / "models"))


def _cli_args(out) -> list:
    p = _paths(out)
    return ["--data-root", p["data_root"], "--ref-annots-root",
            p["ref_annots_root"], "--image-list", p["image_list"],
            "--mesh-dir", p["mesh_dir"], "--num-classes", str(NUM_CLASS),
            "--image-size", str(CROP), "--iters", str(ITERS),
            "--slot-budget", str(BUDGET), "--device", "cpu"]


def _config(cfg):
    """Either package's Config at the test's size."""
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, num_class=NUM_CLASS,
                                       iters=ITERS, test_iters=ITERS),
        data=dataclasses.replace(cfg.data, image_scale=CROP))


def port_setup(out, variables=None):
    """(trainer, builder, metric) of the port on the CPU, as its CLI builds
    them."""
    from scflow_torch.data.bop import RefineDataset
    from scflow_torch.data.loader import TestBatchBuilder
    from scflow_torch.metrics import ADDMetric
    from scflow_torch.rendering import Renderer, load_mesh_dir
    from scflow_torch.training import (YCBV_CLASS_NAMES, Config,
                                       build_points_bank)
    from scflow_torch.training.trainer import Trainer
    from scflow_torch.weights import load_jax_variables

    p = _paths(out)
    cfg = _config(Config())
    cfg.render.image_size = (CROP, CROP)
    bank = load_mesh_dir(p["mesh_dir"], device="cpu")
    points = build_points_bank(bank, num_points=1000)
    trainer = Trainer(cfg, Renderer(bank, image_size=(CROP, CROP)), points,
                      device="cpu")
    if variables is not None:
        load_jax_variables(trainer.model, variables)
    mesh_points = list(points.points.numpy())
    builder = TestBatchBuilder(RefineDataset(
        p["data_root"], p["ref_annots_root"], p["image_list"],
        class_names=YCBV_CLASS_NAMES), cfg, mesh_points)
    metric = ADDMetric(points_per_class=mesh_points,
                       diameters=points.diameters.numpy(),
                       class_names=YCBV_CLASS_NAMES)
    return trainer, builder, metric


@pytest.fixture(scope="module")
def runs(tree):
    """Both packages' ``evaluate_dataset`` on the tree with one set of
    weights."""
    from scflow_tpu.data.bop import RefineDataset as JaxRefineDataset
    from scflow_tpu.data.loader import TestBatchBuilder as JaxBuilder
    from scflow_tpu.metrics import ADDMetric as JaxADDMetric
    from scflow_tpu.rendering import Renderer as JaxRenderer
    from scflow_tpu.rendering import load_mesh_dir as jax_load_mesh_dir
    from scflow_tpu.training import Config as JaxConfig
    from scflow_tpu.training import YCBV_CLASS_NAMES
    from scflow_tpu.training import build_points_bank as jax_points_bank
    from scflow_tpu.training.evaluate import \
        evaluate_dataset as jax_evaluate_dataset
    from scflow_tpu.training.steps import TrainState
    from scflow_tpu.training.trainer import Trainer as JaxTrainer
    from scflow_torch.training.evaluate import evaluate_dataset
    from scflow_torch.weights import to_jax_variables

    out, counts = tree
    p = _paths(out)
    trainer, builder, metric = port_setup(out)
    variables = perturb(to_jax_variables(trainer.model))
    trainer, builder, metric = port_setup(out, variables)
    got = evaluate_dataset(trainer, builder, metric, slot_budget=BUDGET,
                           collect_results=True, progress_every=0)

    bank = jax_load_mesh_dir(p["mesh_dir"])
    points = jax_points_bank(bank, num_points=1000)
    cfg = _config(JaxConfig())
    cfg.data.native_crop = "on"
    jax_trainer = JaxTrainer(cfg, JaxRenderer(bank, image_size=(CROP, CROP),
                                              rasterizer="pallas"),
                             points, use_mesh=False)
    jax_trainer.state = TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=jax_trainer.tx.init(variables["params"]))
    mesh_points = [np.asarray(points.points[c]) for c in range(NUM_CLASS)]
    jax_builder = JaxBuilder(JaxRefineDataset(
        p["data_root"], p["ref_annots_root"], p["image_list"],
        class_names=YCBV_CLASS_NAMES), cfg, mesh_points)
    assert jax_builder._native
    jax_metric = JaxADDMetric(points_per_class=mesh_points,
                              diameters=np.asarray(points.diameters),
                              class_names=YCBV_CLASS_NAMES)
    want = jax_evaluate_dataset(jax_trainer, jax_builder, jax_metric,
                                slot_budget=BUDGET, collect_results=True,
                                progress_every=0)
    return dict(got=got, want=want, metric=metric, jax_metric=jax_metric,
                mesh_points=mesh_points, builder=builder, counts=counts,
                trainer=trainer)


def test_packing_spans_batches_and_flushes(runs):
    """The tree needs several batches of 4 slots, and some image does not
    fit the batch it would join (it starts the next)."""
    from scflow_torch.training.evaluate import pack_eval_batches

    builder = runs["builder"]
    items = [builder[i] for i in range(len(builder))]
    packs = list(pack_eval_batches(items, BUDGET))
    assert len(packs) >= 3
    assert any(used < BUDGET for used in (int(b["sample_valid"].sum())
                                          for b, _ in packs[:-1]))
    assert sum(len(m) for _, m in packs) == IMAGES


def test_poses_match_jax(runs):
    """Every image's refined poses: rotations within atol 2e-3,
    translations within rtol 2e-3 / atol 2e-4 (the eval step's bounds,
    test_torch_port_slice.py); the pose moved from the initial one."""
    got, want = runs["got"][1], runs["want"][1]
    assert len(got) == len(want) == IMAGES
    moved = 0.0
    for g, w, i in zip(got, want, range(IMAGES)):
        assert (g["scene_id"], g["img_id"]) == (w["scene_id"], w["img_id"]) == (1, i)
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["rotations"], w["rotations"],
                                   atol=ROT_ATOL, rtol=0)
        np.testing.assert_allclose(g["translations"], w["translations"],
                                   atol=TRANS_ATOL, rtol=TRANS_RTOL)
        item = runs["builder"][i]
        moved = max(moved, np.abs(g["translations"]
                                  - item["ref_translations"]).max())
    assert moved > 1e-3


def test_add_records_match_jax(runs):
    """Per GT object, ADD and ADD-S of the port's and JAX's poses: the same
    matches, and errors apart by at most the pose bounds carried through
    (3·2e-3 × the largest point radius + the translation bound's norm)."""
    got = runs["metric"]._records
    want = runs["jax_metric"]._records
    assert len(got) == len(want) == runs["counts"]["objects"]
    n = 0
    for g, w in zip(got, want):
        assert (g["label"], g["matched"]) == (w["label"], w["matched"])
        if not w["matched"]:
            continue
        assert (g["pred_idx"], g["gt_idx"]) == (w["pred_idx"], w["gt_idx"])
        radius = np.linalg.norm(runs["mesh_points"][w["label"]], axis=-1).max()
        n += 1
        for key in ("add", "adds"):
            assert np.isfinite(g[key])
            bound = 3 * ROT_ATOL * radius + 3 * (TRANS_ATOL + TRANS_RTOL * 1200)
            assert abs(g[key] - w[key]) <= bound, (key, g[key], w[key])
    assert n == len(want)


def test_jax_metric_on_port_poses_matches(runs, tree):
    """JAX's ``ADDMetric`` fed the port's predictions gives the port's
    metric dict exactly."""
    from scflow_tpu.metrics import ADDMetric as JaxADDMetric
    from scflow_torch.training import YCBV_CLASS_NAMES

    metric = JaxADDMetric(points_per_class=runs["mesh_points"],
                          diameters=runs["metric"].diameters,
                          class_names=YCBV_CLASS_NAMES)
    builder = runs["builder"]
    for res in runs["got"][1]:
        item = builder[res["img_id"]]
        metric.process({k: res[k] for k in ("labels", "rotations",
                                             "translations", "scores")},
                       {"labels": item["gt_labels"],
                        "rotations": item["gt_rotations"],
                        "translations": item["gt_translations"]},
                       k=item["ori_k"])
    assert metric.compute() == runs["got"][0]
    assert runs["got"][0]["num_instances"] == runs["counts"]["objects"]


def test_pose_graph_is_refused(runs):
    """``evaluate_dataset`` no longer refuses ``pose_graph_metric``: with
    it, the plain metric is the run's without it, and an image of one
    object reaches the second metric with its plain poses (the pose
    graph's parity with JAX is in test_torch_port_pose_graph.py)."""
    from scflow_torch.metrics import ADDMetric
    from scflow_torch.training import YCBV_CLASS_NAMES
    from scflow_torch.training.evaluate import evaluate_dataset

    def metric():
        return ADDMetric(points_per_class=runs["mesh_points"],
                         diameters=runs["metric"].diameters,
                         class_names=YCBV_CLASS_NAMES)

    plain, pg = metric(), metric()
    got, results = evaluate_dataset(
        runs["trainer"], runs["builder"], plain, slot_budget=BUDGET,
        collect_results=True, progress_every=0, pose_graph_metric=pg)
    assert got == runs["got"][0]
    start = 0
    for res in results:
        n = len(res["labels"])
        if n == 1:
            assert pg._records[start] == plain._records[start]
        start += len(runs["builder"][res["img_id"]]["gt_labels"])
    assert pg.compute()["num_instances"] == got["num_instances"]


def test_cli_runs_end_to_end(tree, tmp_path, capsys):
    """``python -m scflow_torch.test --device cpu``: the table and the
    summary keys are printed; ``--save-dir`` writes the BOP file of the
    evaluated images; ``--format-only`` writes it and prints no table;
    ``--limit`` evaluates that many images; ``--passes 2`` refines twice;
    ``--pose-graph`` prints the second table with each average's change
    (``--config`` is run in ``test_torch_port_traindata.py``)."""
    from scflow_torch.test import main

    out, counts = tree
    base = _cli_args(out)
    metrics, results = main(base + ["--save-dir", str(tmp_path / "res")])
    printed = capsys.readouterr().out
    assert "| average" in printed and "instance AUC" in printed
    assert f"num_instances: {counts['objects']}" in printed
    assert len(results) == IMAGES
    assert (tmp_path / "res" / "000001" / "scene_gt.json").exists()

    _, only = main(base + ["--format-only", "--work-dir", str(tmp_path / "w"),
                           "--limit", "2"])
    printed = capsys.readouterr().out
    assert "| average" not in printed and "wrote 1 BOP scene files" in printed
    assert len(only) == 2
    assert (tmp_path / "w" / "bop_results" / "000001" / "scene_gt.json").exists()
    for a, b in zip(only, results):
        np.testing.assert_array_equal(a["translations"], b["translations"])

    two, twice = main(base + ["--passes", "2", "--limit", "2", "--save-dir",
                              str(tmp_path / "res2")])
    assert two["num_instances"] == sum(len(r["labels"]) for r in only)
    gap = max(np.abs(a["translations"] - b["translations"]).max()
              for a, b in zip(twice, only))
    assert gap > 0             # the second pass moved the poses further
    capsys.readouterr()
    pg, _ = main(base + ["--pose-graph"])
    printed = capsys.readouterr().out
    assert "== with scene pose-graph refinement ==" in printed
    assert "average/add_0.10d: " in printed and "(Δ " in printed
    assert pg["pose_graph"]["num_instances"] == counts["objects"]
    assert {k: v for k, v in pg.items() if k != "pose_graph"} == metrics


BLOCKED_RUN = """
import sys
for name in ("cv2", "PIL", "jax", "scflow_tpu"):
    sys.modules[name] = None        # any import of it now raises
from scflow_torch.tools.make_synthetic_bop import main as make
from scflow_torch.test import main
out = sys.argv[1]
make(["--out", out, "--num-images", "3", "--num-classes", "2", "--height",
      "96", "--width", "128", "--device", "cpu"])
metrics, _ = main(["--data-root", out + "/test", "--ref-annots-root",
                   out + "/init_poses", "--image-list",
                   out + "/image_lists/test.txt", "--mesh-dir",
                   out + "/models", "--num-classes", "2", "--image-size",
                   "64", "--iters", "1", "--device", "cpu", "--save-dir",
                   out + "/res"])
print("INSTANCES", metrics["num_instances"])
"""


def test_eval_path_runs_without_cv2_and_pil(tmp_path):
    """The tool and the CLI in a process where cv2, PIL and JAX cannot be
    imported: the whole eval path (PNG write and read, crops, refinement,
    metric, BOP writer) runs."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", BLOCKED_RUN, str(tmp_path)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "INSTANCES" in r.stdout and "| average" in r.stdout
    assert (tmp_path / "res" / "000001" / "scene_gt.json").exists()


def test_predict_casts_bf16_crops_on_the_host(tree):
    """A bf16 SCFlow Trainer's ``predict``: float crops reach the eval step
    as bf16 tensors, and the poses equal those of the f32 crops given to
    the eval step directly, bit for bit; uint8 crops are not cast."""
    from scflow_torch.training import ModelConfig, make_eval_step
    from scflow_torch.training.trainer import Trainer

    out, _ = tree
    trainer, builder, _ = port_setup(out)
    cfg = dataclasses.replace(trainer.cfg, model=dataclasses.replace(
        trainer.cfg.model, dtype="bfloat16"))
    assert isinstance(cfg.model, ModelConfig)
    bf16 = Trainer(cfg, trainer.renderer, trainer.points_bank, device="cpu")
    item = builder[0]
    batch = {k: item[k] for k in ("real_images", "ref_rotations",
                                  "ref_translations", "k", "labels")}
    seen = []
    step = bf16.eval_step
    bf16.eval_step = lambda b: seen.append(b["real_images"].dtype) or step(b)
    got = bf16.predict(batch)
    want = make_eval_step(bf16.model, bf16.renderer, cfg, device="cpu")(batch)
    assert seen == [torch.bfloat16]
    for k in ("rotations", "translations"):
        np.testing.assert_array_equal(got[k], want[k].numpy())
    bf16.predict(dict(batch, real_images=(item["real_images"] * 255)
                      .astype(np.uint8)))
    assert seen[-1] == np.uint8         # as given: normalised on the device


@contextlib.contextmanager
def _no_host_tensors():
    """Make ``torch.tensor``, ``new_tensor`` and ``as_tensor`` of host
    values raise."""
    def refuse(*args, **kw):
        raise AssertionError("a tensor made from host values in the step")

    real_as_tensor = torch.as_tensor

    def as_tensor(data, *args, **kw):
        if not isinstance(data, torch.Tensor):
            refuse()
        return real_as_tensor(data, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "tensor", refuse)
        mp.setattr(torch.Tensor, "new_tensor", refuse)
        mp.setattr(torch, "as_tensor", as_tensor)
        yield


@pytest.mark.parametrize("shader", ["phong", "gouraud", "flat"])
def test_eval_step_makes_no_tensor_from_host_values(tree, shader):
    """The eval step on a batch already on its device copies nothing from
    the host (on the card such a copy waits for every queued kernel): its
    constants are made when the step and the renderer are built. The
    outputs equal those of a step run without the guard."""
    from scflow_torch.rendering import Renderer
    from scflow_torch.training import make_eval_step

    out, _ = tree
    trainer, builder, _ = port_setup(out)
    renderer = Renderer(trainer.renderer.mesh_bank, image_size=(CROP, CROP),
                        shader_type=shader)
    step = make_eval_step(trainer.model, renderer, trainer.cfg, device="cpu")
    item = builder[1]
    batch = {k: torch.from_numpy(np.asarray(item[k])) for k in (
        "real_images", "ref_rotations", "ref_translations", "k", "labels")}
    want = step(batch)
    with _no_host_tensors():
        got = step(batch)
    for k in ("rotations", "translations"):
        assert torch.equal(got[k], want[k]), k
