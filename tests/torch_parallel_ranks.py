"""Rank functions for the multi-process tests of the PyTorch port
(``test_torch_port_parallel.py``, ``test_torch_port_pose_graph.py``,
``test_torch_port_profile_tools.py``).

Each runs in a process spawned by ``scflow_torch.parallel.mesh.spawn``
inside a gloo group, so it must import by name and stay free of JAX:
everything is rebuilt from its arguments and seeds.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

TRAIN_CLASSES, TRAIN_IMAGE, TRAIN_ITERS, TRAIN_BATCH = 4, (64, 64), 2, 4


def collectives(seed: int) -> dict:
    """reduce_metrics, allgather_results and a MetricAccumulator fed this
    rank's part of :func:`accumulator_inputs`, merged by reduce_metrics."""
    from scflow_torch.parallel import (MetricAccumulator, allgather_results,
                                       rank, reduce_metrics, world_size)

    r, w = rank(), world_size()
    sums = reduce_metrics({
        "int": torch.arange(3, dtype=torch.int32) * (r + 1),
        "float": torch.full((2, 2), 0.25 * (r + 1)),
        "scalar": torch.tensor(float(r))})
    gathered = allgather_results({
        "ids": np.arange(r + 1, dtype=np.int64) + 10 * r,
        "rows": np.full((r + 1, 2), r, np.float64)})
    acc = MetricAccumulator(num_classes=5)
    labels, errors, diameters, valid = accumulator_inputs(seed)
    part = slice(r * len(labels) // w, (r + 1) * len(labels) // w)
    state = acc.init("cpu")
    acc.update(state, *(torch.from_numpy(a[part]) for a in
                        (labels, errors, diameters, valid)))
    return {"sums": {k: v.numpy() for k, v in sums.items()},
            "gathered": gathered,
            "metric": acc.compute(reduce_metrics(state))}


@contextlib.contextmanager
def one_thread_each():
    """Processes spawned inside run one torch thread each: beside the
    other test workers, a rank's OpenMP barriers wait on descheduled
    threads, and its collectives then wait on the slow rank."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old


def checks(seed: int, eval_args: tuple, work_dir: str,
           train_tree: str) -> dict:
    """Every check of ``test_torch_port_parallel.py`` on this rank, in one
    process group (one spawn for all of them): :func:`collectives`,
    :func:`evaluate_tree`, :func:`train_step`, :func:`train_cli` and
    :func:`train_cli_disk`."""
    return {"collectives": collectives(seed),
            "evaluate": evaluate_tree(*eval_args),
            "train_step": train_step(),
            "train_cli": train_cli(work_dir),
            "train_cli_disk": train_cli_disk(train_tree, work_dir)}


def accumulator_inputs(seed: int, n: int = 40):
    """(labels, errors mm, diameters, valid) of ``n`` seeded instances."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 5, n).astype(np.int64)
    errors = rng.uniform(0, 120, n).astype(np.float32)
    diameters = rng.uniform(50, 200, n).astype(np.float32)
    valid = (rng.uniform(size=n) > 0.2).astype(np.float32)
    return labels, errors, diameters, valid


def evaluate_tree(tree: str, num_class: int, crop: int, iters: int,
                  budget: int) -> tuple:
    """The port's evaluate_dataset with a pose-graph metric on a BOP tree
    the tool wrote, with the seeded weights: (metric dict, pose-graph
    metric dict, this process's results)."""
    from scflow_torch.data.bop import RefineDataset
    from scflow_torch.data.loader import TestBatchBuilder
    from scflow_torch.metrics import ADDMetric
    from scflow_torch.rendering import Renderer, load_mesh_dir
    from scflow_torch.training import (YCBV_CLASS_NAMES, Config, DataConfig,
                                       ModelConfig, RenderConfig,
                                       build_points_bank)
    from scflow_torch.training.evaluate import evaluate_dataset
    from scflow_torch.training.trainer import Trainer

    cfg = Config(model=ModelConfig(num_class=num_class, iters=iters,
                                   test_iters=iters),
                 render=RenderConfig(image_size=(crop, crop)),
                 data=DataConfig(image_scale=crop))
    bank = load_mesh_dir(f"{tree}/models", device="cpu")
    points = build_points_bank(bank, num_points=1000)
    trainer = Trainer(cfg, Renderer(bank, image_size=(crop, crop)), points,
                      device="cpu")
    mesh_points = list(points.points.numpy())
    builder = TestBatchBuilder(RefineDataset(
        f"{tree}/test", f"{tree}/init_poses",
        f"{tree}/image_lists/test.txt", class_names=YCBV_CLASS_NAMES), cfg,
        mesh_points)

    def metric():
        return ADDMetric(points_per_class=mesh_points,
                         diameters=points.diameters.numpy(),
                         class_names=YCBV_CLASS_NAMES)

    plain, pg = metric(), metric()
    got, results = evaluate_dataset(trainer, builder, plain,
                                    slot_budget=budget, collect_results=True,
                                    progress_every=0, pose_graph_metric=pg)
    return got, pg.compute(), results


def train_setup():
    """(model, config, renderer, points bank, optimizer) of the DP train
    tests on the CPU: 4 classes, 64², 2 iterations, seeded weights."""
    from scflow_torch.rendering import Renderer, make_test_meshes
    from scflow_torch.training import (Config, LossConfig, ModelConfig,
                                       OptimConfig, RenderConfig, build_model,
                                       build_points_bank, make_optimizer)

    cfg = Config(model=ModelConfig(num_class=TRAIN_CLASSES, iters=TRAIN_ITERS,
                                   test_iters=TRAIN_ITERS),
                 loss=LossConfig(num_loss_points=64),
                 optim=OptimConfig(total_steps=100),
                 render=RenderConfig(image_size=TRAIN_IMAGE))
    bank = make_test_meshes(TRAIN_CLASSES, subdivisions=1, radius=60.0,
                            device="cpu")
    renderer = Renderer(bank, image_size=TRAIN_IMAGE)
    points = build_points_bank(bank, symmetric_classes=(1,), num_points=64)
    model = build_model(cfg, device="cpu", seed=1)
    return model, cfg, renderer, points, make_optimizer(cfg,
                                                        model.parameters())


def train_batch(renderer) -> dict:
    """The global batch: seeded synthetic scenes, the last slot masked."""
    from scflow_torch.data import synthetic_batch

    batch = synthetic_batch(torch.Generator().manual_seed(3), renderer,
                            TRAIN_BATCH)
    valid = torch.ones(TRAIN_BATCH)
    valid[-1] = 0.0
    return dict(batch, sample_valid=valid)


def train_step() -> dict:
    """One train step on this process's shard of :func:`train_batch`
    (the whole batch without a group): loss, metrics, the clipped
    gradient scaled back by the clip, BN running statistics and the
    updated parameters, as numpy."""
    from scflow_torch.parallel import shard_batch
    from scflow_torch.training import make_train_step

    model, cfg, renderer, points, opt = train_setup()
    step = make_train_step(model, renderer, points, cfg, opt, device="cpu")
    metrics = step(shard_batch(train_batch(renderer)))
    factor = max(metrics["grad_norm"].item() / cfg.optim.grad_clip_norm, 1.0)
    return {
        "metrics": {k: v.numpy() for k, v in metrics.items()},
        "grads": {n: p.grad.numpy() * factor
                  for n, p in model.named_parameters() if p.grad is not None},
        "stats": {n: b.numpy() for n, b in model.named_buffers()
                  if "running" in n},
        "params": {n: p.detach().numpy()
                   for n, p in model.named_parameters()},
    }


def train_cli(work_dir: str) -> list:
    """``scflow_torch.train.main`` (synthetic, 2 steps, panels and eval
    every step) into ``work_dir``/rank<r>: the files this rank wrote and
    its final parameters' checksum."""
    import os

    from scflow_torch.parallel import rank
    from scflow_torch.train import main

    out = os.path.join(work_dir, f"rank{rank()}")
    trainer = main(["--synthetic", "--device", "cpu", "--steps", "2",
                    "--image-size", "64", "--num-classes", "3", "--iters",
                    "1", "--batch-size", "4", "--work-dir", out,
                    "--panel-every", "1", "--eval-every", "2"])
    files = sorted(os.path.relpath(os.path.join(d, f), out)
                   for d, _, fs in os.walk(out) for f in fs)
    total = float(sum(p.detach().double().sum()
                      for p in trainer.model.parameters()))
    return [files, total, trainer.step]


def train_cli_disk(tree: str, work_dir: str) -> list:
    """``scflow_torch.train.main`` from the ``train_real`` split of
    ``tree`` (global batch 4, 2 steps) into ``work_dir``/disk<r>: the size
    and pixel sum of each batch this rank trained on, its final
    parameters' checksum and its step."""
    import os

    import scflow_torch.train as train
    from scflow_torch.parallel import rank

    seen, real = [], train.prefetch

    def recording(builder, *args, **kwargs):
        batches = real(builder, *args, **kwargs)

        def recorded():
            try:
                for b in batches:
                    seen.append([len(b["labels"]), float(
                        np.asarray(b["real_images"], np.float64).sum())])
                    yield b
            finally:
                batches.close()
        return recorded()

    train.prefetch = recording
    try:
        trainer = train.main([
            "--device", "cpu", "--data-root", f"{tree}/train_real",
            "--image-list", f"{tree}/image_lists/train_real.txt",
            "--mesh-dir", f"{tree}/models", "--num-classes", "3",
            "--image-size", "64", "--iters", "1", "--batch-size", "4",
            "--steps", "2", "--work-dir",
            os.path.join(work_dir, f"disk{rank()}")])
    finally:
        train.prefetch = real
    total = float(sum(p.detach().double().sum()
                      for p in trainer.model.parameters()))
    return [seen, total, trainer.step]


def sharded_solve(inputs: dict) -> dict:
    """solve_pose_graph_sharded on this rank's contiguous share of the
    objects in ``inputs`` (numpy, the global arrays, k per object)."""
    from scflow_torch.parallel import rank, world_size
    from scflow_torch.parallel.pose_graph import solve_pose_graph_sharded

    n = inputs["points"].shape[0]
    part = slice(rank() * n // world_size(), (rank() + 1) * n // world_size())
    t = {k: torch.from_numpy(v[part]) for k, v in inputs.items()}
    out = solve_pose_graph_sharded(t["points"], t["target_2d"],
                                   t["rotations"], t["translations"],
                                   t["k"], t["weights"], iterations=5)
    return {k: v.numpy() for k, v in out.items()}


def allreduce_off_by_one(sizes_mb: list):
    """``comm_bench.allreduce_rank`` with an all-reduce that adds 1 to one
    element: the rank's exact check must raise; returns its message."""
    import torch.distributed as dist

    from scflow_torch.tools import comm_bench

    real = dist.all_reduce

    def off_by_one(t, *args, **kwargs):
        real(t, *args, **kwargs)
        t.view(-1)[0] += 1

    dist.all_reduce = off_by_one
    try:
        comm_bench.allreduce_rank(sizes_mb, "cpu")
    except AssertionError as e:
        return str(e)
    finally:
        dist.all_reduce = real
    return None
