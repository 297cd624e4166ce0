"""The port's Trainer, checkpoints, on-device eval and training CLI against
the JAX package's, on the CPU.

64² crops, 3 classes (icospheres and a box, the box symmetric), batch 2,
2 GRU iterations, full width; the port's seeded init with seeded noise,
bridged into both packages; JAX renders with the Pallas tile rasterizer in interpret mode (as
its own tests do), the port with its plain tile pass. One JAX Trainer
(``use_mesh=False``, as ``tests/test_evaluate.py`` builds it) serves every
JAX program: its eval on the initial weights, a 3-step ``fit`` with
panels and checkpoints, its panel step (captured from ``fit``) and
``predict``.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_common import IMAGE, NUM_CLASS, perturb
from port_common import one_torch_thread  # noqa: F401 (autouse)

ITERS = 2
RADIUS = 20.0
SYMMETRIC = (1,)
NUM_POINTS = 64
STEPS = 3
PANEL_EVERY = 2
CKPT_EVERY = 2
PADDED = np.array([1.0, 0.0], np.float32)
LOSS_TERMS = ("loss", "loss_pose", "loss_flow", "loss_mask")


def _config(cfg, work_dir: str):
    """``cfg`` (either package's Config) cut to the test's size."""
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, num_class=NUM_CLASS,
                                       iters=ITERS, test_iters=ITERS),
        loss=dataclasses.replace(cfg.loss, num_loss_points=NUM_POINTS),
        optim=dataclasses.replace(cfg.optim, total_steps=100),
        data=dataclasses.replace(cfg.data, batch_size=2),
        log_interval=1, checkpoint_interval=CKPT_EVERY, work_dir=work_dir)


@pytest.fixture(scope="module")
def jax_side():
    from scflow_tpu.data import synthetic_batch
    from scflow_tpu.rendering import Renderer, make_test_meshes
    from scflow_tpu.training import build_points_bank

    from scflow_torch.weights import to_jax_variables

    # the port's seeded init in the flax layout, its init-constant leaves
    # replaced by seeded noise (no JAX init program to compile)
    variables = perturb(to_jax_variables(port_trainer(None, "unused").model))
    bank = make_test_meshes(num_classes=NUM_CLASS, subdivisions=2,
                            radius=RADIUS)
    renderer = Renderer(bank, image_size=IMAGE, rasterizer="pallas")
    points = build_points_bank(bank, symmetric_classes=SYMMETRIC,
                               num_points=NUM_POINTS)
    batches = [jax.tree.map(np.asarray, synthetic_batch(
        jax.random.PRNGKey(10 + i), renderer, 2)) for i in range(STEPS)]
    return variables, renderer, points, batches


def _read_log(work_dir) -> list[dict]:
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _images(work_dir) -> list[str]:
    return sorted(os.listdir(os.path.join(work_dir, "images")))


@pytest.fixture(scope="module")
def jax_run(jax_side, tmp_path_factory):
    """The JAX Trainer: eval on the initial weights (a padded batch), then
    fit with panels and checkpoints; its panel step is captured."""
    import scflow_tpu.training.steps as jsteps
    import scflow_tpu.training.trainer as jtrainer
    from scflow_tpu.training import Config
    from scflow_tpu.training.checkpoint import list_checkpoint_steps
    from scflow_tpu.training.evaluate import evaluate_device_accumulator
    from scflow_tpu.training.steps import TrainState
    from scflow_tpu.training.trainer import Trainer

    variables, renderer, points, batches = jax_side
    work = str(tmp_path_factory.mktemp("jax_fit"))
    trainer = Trainer(_config(Config(), work), renderer, points,
                      use_mesh=False)
    trainer.state = TrainState(step=jnp.zeros((), jnp.int32),
                               params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=trainer.tx.init(variables["params"]))
    evaluated = evaluate_device_accumulator(
        trainer, [dict(batches[0], sample_valid=PADDED)], points, NUM_CLASS)

    made = {}
    original = jsteps.make_panel_step

    def capture(*args, **kw):
        made["panel"] = original(*args, **kw)
        return made["panel"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsteps, "make_panel_step", capture)
        trainer.fit(lambda s: batches[s], num_steps=STEPS,
                    panel_every=PANEL_EVERY)
    panel0 = jax.tree.map(np.asarray, made["panel"](
        variables["params"], variables["batch_stats"], batches[0]))
    log = _read_log(work)
    ckpts = list_checkpoint_steps(os.path.join(work, "checkpoints"))

    # JAX's own spread: the same fit with the reference translations (so
    # the renders inside the train step) 1e-6 further out
    nudged = [dict(b, ref_translations=b["ref_translations"]
                   * np.float32(1 + 1e-6)) for b in batches]
    trainer.cfg.work_dir = str(tmp_path_factory.mktemp("jax_nudged"))
    trainer._log_file = trainer._tb_writer = None      # open in the new dir
    trainer.state = TrainState(step=jnp.zeros((), jnp.int32),
                               params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=trainer.tx.init(variables["params"]))
    with pytest.MonkeyPatch.context() as mp:    # its checkpoints: not needed
        mp.setattr(jtrainer, "save_checkpoint", lambda *a, **kw: None)
        trainer.fit(lambda s: nudged[s], num_steps=STEPS)
    return dict(trainer=trainer, work=work, log=log, images=_images(work),
                eval=evaluated, panel0=panel0, ckpts=ckpts,
                nudged_log=_read_log(trainer.cfg.work_dir))


def port_trainer(variables, work_dir: str):
    """A port Trainer on the CPU at the test's size with the bridged
    weights."""
    from scflow_torch.rendering import Renderer, make_test_meshes
    from scflow_torch.training import Config, build_points_bank
    from scflow_torch.training.trainer import Trainer
    from scflow_torch.weights import load_jax_variables

    cfg = _config(Config(), work_dir)
    cfg.render.image_size = IMAGE
    bank = make_test_meshes(NUM_CLASS, subdivisions=2, radius=RADIUS,
                            device="cpu")
    trainer = Trainer(cfg, Renderer(bank, image_size=IMAGE),
                      build_points_bank(bank, symmetric_classes=SYMMETRIC,
                                        num_points=NUM_POINTS),
                      device="cpu")
    if variables is not None:
        load_jax_variables(trainer.model, variables)
    return trainer


@pytest.fixture(scope="module")
def port_run(jax_side, tmp_path_factory):
    from scflow_torch.training.checkpoint import list_checkpoint_steps
    from scflow_torch.training.evaluate import evaluate_device_accumulator

    variables, _, _, batches = jax_side
    work = str(tmp_path_factory.mktemp("port_fit"))
    trainer = port_trainer(variables, work)
    evaluated = evaluate_device_accumulator(
        trainer, [dict(batches[0], sample_valid=PADDED)],
        trainer.points_bank, NUM_CLASS)
    trainer.fit(lambda s: batches[s], num_steps=STEPS,
                panel_every=PANEL_EVERY)
    trainer.close()
    return dict(trainer=trainer, work=work, log=_read_log(work),
                images=_images(work), eval=evaluated,
                ckpts=list_checkpoint_steps(os.path.join(work,
                                                         "checkpoints")))


def test_fit_logs_match_jax(jax_run, port_run):
    """3 steps of ``fit``: the same records (steps and keys), the same
    checkpoint steps and panel files; ``lr`` within 1e-7 relative (the
    port's schedule is float64, optax's f32); step 1's loss terms within
    1e-5 relative (measured ≤ 3.2e-6).

    After an update, the f32 train step is ill-conditioned: Adam moves
    every element whose gradient the two packages' ~1e-3 gradient gap can
    flip by 2·lr (test_torch_port_train.py). JAX's own spread is measured:
    the relative change of its values when the reference translations, and
    so the renders inside the step, move by 1e-6. Each step's loss terms
    (the total too) are held within 5× the largest spread among that
    step's terms (the total's own spread can vanish by cancellation), and
    ``grad_norm`` within 5× its own spread; 1e-4 relative at least.
    Measured: at most 2.4× the spread."""
    want, got = jax_run["log"], port_run["log"]
    assert ([(r["step"], sorted(r)) for r in got]
            == [(r["step"], sorted(r)) for r in want])
    assert port_run["ckpts"] == jax_run["ckpts"] == [2, 3]
    assert port_run["images"] == jax_run["images"] == [
        "train_panel_00000002.png"]
    train = [(g, w) for g, w in zip(got, want) if "loss" in w]
    nudged = jax_run["nudged_log"]
    assert [w["step"] for _, w in train] == [n["step"] for n in nudged] == [
        1, 2, 3]

    def rel(a, b, key):
        return abs(a[key] - b[key]) / abs(b[key])

    for (g, w), n in zip(train, nudged):
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-7)
        spread = max(rel(n, w, key) for key in LOSS_TERMS)
        for key in LOSS_TERMS:
            assert rel(g, w, key) <= max(1e-4, 5 * spread), (w["step"], key)
            if w["step"] == 1:
                assert rel(g, w, key) <= 1e-5, key
        assert rel(g, w, "grad_norm") <= max(
            1e-4, 5 * rel(n, w, "grad_norm")), w["step"]


def test_panel_step_matches_jax(jax_side, jax_run):
    """``make_panel_step`` on the initial weights against the JAX panel
    step that ``fit`` built, on train batch 0: real and rendered images
    within 1e-4 (renders agree to 4.4e-5, test_torch_port_render.py);
    flows, the mask and the per-iteration EPE at the eval slice's bounds
    (test_torch_port_slice.py: flow rtol 2e-3, atol 2e-3; masks 1e-3)."""
    from scflow_torch.training import make_panel_step

    variables, _, _, batches = jax_side
    trainer = port_trainer(variables, "unused")
    got = {k: v.numpy() for k, v in make_panel_step(
        trainer.model, trainer.renderer, trainer.cfg, device="cpu")(
        batches[0]).items()}
    want = jax_run["panel0"]
    assert set(got) == set(want)
    for k in ("real", "render"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    for k in ("gt_flow", "pose_flow", "pred_flow"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-3,
                                   err_msg=k)
    np.testing.assert_allclose(got["mask"], want["mask"], atol=1e-3)
    assert got["epe_per_iter"].shape == (ITERS,)
    np.testing.assert_allclose(got["epe_per_iter"], want["epe_per_iter"],
                               rtol=2e-3)


def test_device_accumulator_eval_matches_jax(jax_run, port_run):
    """``evaluate_device_accumulator`` on the initial weights over a batch
    whose second slot is padded (sample_valid 0): one instance counted,
    the same threshold accuracies, AUC and bracket within 1e-6."""
    got, want = port_run["eval"], jax_run["eval"]
    assert set(got) == set(want)
    assert got["num_instances"] == want["num_instances"] == 1
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def _state(trainer) -> dict:
    """Every model tensor and AdamW state tensor, and the step."""
    out = {f"model/{k}": v for k, v in trainer.model.state_dict().items()}
    for i, (_, s) in enumerate(sorted(
            trainer.optimizer.state_dict()["state"].items())):
        for k, v in s.items():
            out[f"adamw/{i}/{k}"] = v
    out["step"] = torch.tensor(trainer.step)
    return out


def test_resume_round_trip_is_bit_exact(jax_side, tmp_path):
    """Port only: fit 4 steps in one go, against fit 2 → final checkpoint →
    a fresh Trainer ``resume`` → fit to 4. Parameters, BN statistics,
    AdamW moments, the step and the logged lr are bit-equal."""
    variables, _, _, batches = jax_side
    batches = batches + batches[:1]

    def get_batch(step):
        return batches[step]

    whole = port_trainer(variables, str(tmp_path / "whole"))
    whole.fit(get_batch, num_steps=4)
    split = port_trainer(variables, str(tmp_path / "split"))
    split.fit(get_batch, num_steps=2)
    split.close()
    fresh = port_trainer(None, str(tmp_path / "split"))
    assert fresh.resume() == 2 and fresh.step == 2
    fresh.fit(get_batch, num_steps=4)
    for t in (whole, fresh):
        t.close()
    a, b = _state(whole), _state(fresh)
    assert a.keys() == b.keys() and int(a["step"]) == 4
    for k in a:
        assert torch.equal(a[k], b[k]), k
    lr = [[r["lr"] for r in _read_log(str(tmp_path / d)) if r["step"] > 2]
          for d in ("whole", "split")]
    assert lr[0] == lr[1] and len(lr[0]) == 2
    # init_state: back to cfg.seed's weights and an empty AdamW state
    whole.init_state()
    seeded = port_trainer(None, "unused").model.state_dict()
    assert whole.step == 0 and not whole.optimizer.state
    for k, v in whole.model.state_dict().items():
        assert torch.equal(v, seeded[k]), k


def test_torch_checkpoint_loads_into_both_packages(jax_side, jax_run,
                                                   tmp_path):
    """One mmengine-wrapped ``.pth`` with ``module.`` prefixes (the port's
    state_dict from its own seeded init, which differs from both trainers'
    weights) loads into the port (nothing missing or unused) and into the
    JAX Trainer; their eval-step poses on a train batch agree within the
    eval slice's bounds (rotations atol 2e-3; translations rtol 2e-3, atol
    2e-4)."""
    from scflow_torch.training.checkpoint import normalize_torch_state

    _, _, _, batches = jax_side
    source = port_trainer(None, "unused")
    source.init_eval_state(seed=5)
    state = {f"module.{k}": v for k, v in source.model.state_dict().items()}
    path = str(tmp_path / "ref.pth")
    torch.save({"meta": {"iter": 100}, "state_dict": state}, path)
    assert set(normalize_torch_state(torch.load(path))) == set(
        source.model.state_dict())
    port = port_trainer(jax_side[0], "unused")
    report = port.load_torch_checkpoint(path)
    assert report["missing"] == [] and report["unused"] == []
    assert len(report["covered"]) == len(state)
    jax_trainer = jax_run["trainer"]
    jreport = jax_trainer.load_torch_checkpoint(path)
    assert jreport["unused"] == []
    eval_batch = {k: batches[1][k] for k in ("real_images", "ref_rotations",
                                             "ref_translations", "k",
                                             "labels")}
    got = port.predict(eval_batch)
    want = jax_trainer.predict(eval_batch)
    assert set(got) == set(want) == {"rotations", "translations"}
    np.testing.assert_allclose(got["rotations"], want["rotations"],
                               atol=2e-3)
    np.testing.assert_allclose(got["translations"], want["translations"],
                               rtol=2e-3, atol=2e-4)
    moved = np.abs(got["translations"] - eval_batch["ref_translations"])
    assert moved.max() > 1e-3          # the loaded weights refine the pose


def test_cli_trains_logs_and_checkpoints(tmp_path):
    """``scflow_torch.train.main`` on the CPU: 2 steps at 64² with panels
    and the synthetic on-device eval write the JSONL log, a panel, TB event
    files and the final checkpoint; ``--resume`` continues from it; the
    data flags of the JAX CLI are parsed (they are run in
    ``test_torch_port_traindata.py``), a flag it lacks is refused."""
    from scflow_torch.train import main
    from scflow_torch.training.checkpoint import list_checkpoint_steps

    work = str(tmp_path / "run")
    base = ["--synthetic", "--device", "cpu", "--image-size", "64",
            "--num-classes", "3", "--batch-size", "2", "--iters", "2",
            "--work-dir", work]
    trainer = main(base + ["--steps", "2", "--eval-every", "2",
                           "--panel-every", "2"])
    assert trainer.step == 2 and trainer.device.type == "cpu"
    log = _read_log(work)
    assert [r["step"] for r in log] == [1, 2, 2]
    assert any("eval/average/auc" in r for r in log)
    assert any("epe_iter1" in r for r in log)
    assert os.listdir(os.path.join(work, "images")) == [
        "train_panel_00000002.png"]
    assert len(os.listdir(os.path.join(work, "tb"))) == 2
    assert list_checkpoint_steps(os.path.join(work, "checkpoints")) == [2]
    assert main(base + ["--steps", "3", "--resume"]).step == 3
    assert list_checkpoint_steps(os.path.join(work, "checkpoints")) == [2, 3]
    from scflow_torch.train import parse_args

    for flag, field, value in (
            (["--config", "scflow_ycbv_pbr"], "config", "scflow_ycbv_pbr"),
            (["--data-root", "x"], "data_root", "x"),
            (["--scene"], "scene", True), (["--mesh-dir", "x"], "mesh_dir", "x"),
            (["--image-list", "x"], "image_list", "x"),
            (["--mesh-ext", "ply"], "mesh_ext", "ply"),
            (["--scene-images", "2"], "scene_images", 2)):
        assert getattr(parse_args(base + flag), field) == value
    with pytest.raises(SystemExit):
        main(base + ["--pose-graph"])
