"""Training CLI of the port, the twin of the JAX package's ``train.py``:
a named recipe and/or explicit paths give the config and the data; the
model, renderer and points bank are built, then ``Trainer.fit`` runs with
JSONL / TensorBoard logs, image panels, checkpoints and an optional eval.

  # named recipe: its BOP tree, meshes and test split under data/
  python -m scflow_torch.train --config scflow_ycbv_real
  # explicit paths (override the recipe's)
  python -m scflow_torch.train --data-root DATA/train_real \\
      --image-list DATA/image_lists/train_real.txt --mesh-dir DATA/models
  # scene batching: every visible object of 4 images in 4 slots each
  python -m scflow_torch.train --config scflow_ycbv_real --scene
  # synthetic scenes rendered on the device (no data needed)
  python -m scflow_torch.train --synthetic --device cpu --steps 2 \\
      --image-size 64 --num-classes 3 --batch-size 2

Disk batches come from ``TrainBatchBuilder`` (``SceneTrainBatchBuilder``
with ``--scene``) through ``prefetch`` on 3 threads. With
``--eval-every``, a recipe whose test split is on disk is evaluated by
``evaluate_dataset`` (the first ``--eval-limit`` images); otherwise the
on-device ADD(-S) eval runs over 4 seeded synthetic batches.

Unlike the JAX CLI, the port builds no sample batch before training: its
model is initialised without one.

Data-parallel training over several processes, one per device (here two
on the CPU):

  SCFLOW_NUM_PROCESSES=2 SCFLOW_PROCESS_ID=0 python -m scflow_torch.train \\
      --synthetic --device cpu --steps 2 --image-size 64 --num-classes 3 \\
      --batch-size 4 &
  SCFLOW_NUM_PROCESSES=2 SCFLOW_PROCESS_ID=1 python -m scflow_torch.train \\
      --synthetic --device cpu --steps 2 --image-size 64 --num-classes 3 \\
      --batch-size 4

With ``--synthetic`` every process renders the same global batch
(``--batch-size``) from the seed and trains on its slice
(``parallel.shard_batch``). From disk each process builds only its share
of the global batch, from a stream of its own (``_train_builder``), so no
process decodes another's images. Rank 0 writes the logs, panels and
checkpoints.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

from .configs import get_recipe
from .configs.build import build_dataset
from .data import synthetic_batch
from .data.bop import SuperviseTrainDataset
from .data.loader import (SceneTrainBatchBuilder, TestBatchBuilder,
                          TrainBatchBuilder, prefetch)
from .metrics import ADDMetric
from .parallel import initialize_distributed, rank, shard_batch, world_size
from .rendering import Renderer, load_mesh_dir, make_test_meshes
from .training import (YCBV_CLASS_NAMES, YCBV_MESH_DIAMETERS,
                       YCBV_SYMMETRIC_CLASSES, Config, build_points_bank)
from .training.evaluate import evaluate_dataset, evaluate_device_accumulator
from .training.trainer import Trainer


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m scflow_torch.train",
                                description="Train an SCFlow refiner")
    p.add_argument("--config", default=None,
                   help="named recipe from scflow_torch.configs (e.g. "
                        "scflow_ycbv_pbr, raft_ycbv, scflow_track_real)")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--cycles", type=int, default=None,
                   help="multi-cycle training (re-render between cycles)")
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic scenes rendered on the device "
                        "(no data needed)")
    p.add_argument("--scene", action="store_true",
                   help="multi-object scene batching: every visible object "
                        "of each image shares the batch, padded slots are "
                        "masked via sample_valid")
    p.add_argument("--scene-images", type=int, default=None)
    p.add_argument("--slots-per-image", type=int, default=None)
    p.add_argument("--eval-every", type=int, default=None,
                   help="evaluate every N steps: the recipe's test split "
                        "when it is on disk, else the on-device ADD(-S) "
                        "eval over 4 seeded synthetic batches")
    p.add_argument("--eval-limit", type=int, default=200,
                   help="max eval images for --eval-every runs")
    p.add_argument("--panel-every", type=int, default=None,
                   help="dump train image panels (real|render|flows|mask) "
                        "every N steps into work_dir/images")
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--data-root", default=None)
    p.add_argument("--image-list", default=None)
    p.add_argument("--mesh-dir", default=None)
    p.add_argument("--mesh-ext", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu'")
    return p.parse_args(argv)


def resolve_config(args):
    """The recipe's config (``--config``) or the default one, with the
    CLI's flags layered on top, as the JAX CLI layers them: (config,
    train DatasetSpec or None, test DatasetSpec or None)."""
    if args.config:
        recipe = get_recipe(args.config)
        cfg, train_spec = recipe.config, recipe.train_data
        test_spec = recipe.test_data
    else:
        cfg, train_spec, test_spec = Config(), None, None

    m, o, d = cfg.model, cfg.optim, cfg.data
    if args.scene:
        d.scene_mode = True
    if args.scene_images is not None:
        d.scene_images = args.scene_images
    if args.slots_per_image is not None:
        d.slots_per_image = args.slots_per_image
    if d.scene_mode:
        d.batch_size = d.scene_images * d.slots_per_image
    if args.num_classes is not None:
        m.num_class = args.num_classes
    if args.iters is not None:
        m.iters = m.test_iters = args.iters
    if args.cycles is not None:
        m.train_cycles = args.cycles
    if args.lr is not None:
        o.lr = args.lr
    if args.steps is not None:
        o.total_steps = args.steps
    if args.batch_size is not None:
        d.batch_size = args.batch_size
    if args.image_size is not None:
        d.image_scale = args.image_size
    # the port's SCFlow decoder is built for the crop size it will see
    cfg.render.image_size = (d.image_scale, d.image_scale)
    if args.work_dir is not None:
        cfg.work_dir = args.work_dir
    cfg.seed = args.seed
    return cfg, train_spec, test_spec


def _train_builder(args, cfg, train_spec, mesh_points, diameters):
    """The disk batch builder of the CLI's data flags or the recipe. Under
    a process group it builds this rank's share of the global batch
    (``batch_size`` / world samples, or ``scene_images`` / world images),
    from its own stream: the seed plus 1000003 × the rank."""
    sample_num = -1 if cfg.data.scene_mode else 1
    if args.data_root is not None:
        dataset = SuperviseTrainDataset(
            args.data_root, args.image_list, class_names=YCBV_CLASS_NAMES,
            sample_num=sample_num, min_visib_fract=cfg.data.min_visib_fract,
            seed=cfg.seed)
    else:
        dataset = build_dataset(train_spec, seed=cfg.seed,
                                sample_num=sample_num)
    world, seed = world_size(), cfg.seed + 1_000_003 * rank()
    d = cfg.data
    if world > 1:
        flag, share = (("--scene-images", d.scene_images) if d.scene_mode
                       else ("--batch-size", d.batch_size))
        if share % world:
            raise ValueError(f"{flag} {share} does not divide over {world} "
                             f"processes")
        d = dataclasses.replace(d, batch_size=d.batch_size // world,
                                scene_images=d.scene_images // world)
        cfg = dataclasses.replace(cfg, data=d)
    if d.scene_mode:
        return SceneTrainBatchBuilder(
            dataset, cfg, mesh_points, diameters, seed=seed,
            num_images=d.scene_images, slots_per_image=d.slots_per_image)
    return TrainBatchBuilder(dataset, cfg, mesh_points, diameters, seed=seed)


def main(argv=None) -> Trainer:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); returns the
    trainer after ``fit``."""
    args = parse_args(argv)
    device = initialize_distributed(device=args.device)
    cfg, train_spec, test_spec = resolve_config(args)
    num_classes = cfg.model.num_class
    size = cfg.data.image_scale

    mesh_dir = args.mesh_dir or (train_spec.mesh_dir if train_spec else None)
    mesh_ext = args.mesh_ext or (train_spec.mesh_ext if train_spec else "ply")
    if args.synthetic and mesh_dir and not os.path.isdir(mesh_dir):
        mesh_dir = None  # smoke mode without the recipe's meshes on disk
    if mesh_dir:
        bank = load_mesh_dir(mesh_dir, ext=mesh_ext, device=device)
        if train_spec is not None:
            symmetric = train_spec.symmetric_classes
            diameters = train_spec.diameters
        else:
            symmetric = YCBV_SYMMETRIC_CLASSES if num_classes == 21 else ()
            diameters = YCBV_MESH_DIAMETERS if num_classes == 21 else None
    else:
        bank = make_test_meshes(num_classes, subdivisions=2, device=device)
        symmetric, diameters = (), None

    renderer = Renderer(bank, image_size=(size, size))
    points = build_points_bank(bank, symmetric_classes=symmetric,
                               diameters=diameters,
                               num_points=cfg.loss.num_loss_points)
    trainer = Trainer(cfg, renderer, points, device=device)
    if args.resume:
        trainer.resume()
    mesh_points = list(points.points.cpu().numpy())
    mesh_diameters = points.diameters.cpu().numpy()

    batches = None
    use_disk_data = (args.data_root is not None or
                     (train_spec is not None and not args.synthetic))
    if use_disk_data:
        batches = prefetch(_train_builder(args, cfg, train_spec, mesh_points,
                                          list(mesh_diameters)))

        def get_batch(step: int) -> dict:
            return next(batches)
    else:
        def get_batch(step: int) -> dict:
            return shard_batch(synthetic_batch(
                torch.Generator().manual_seed(cfg.seed * 1000_003 + step),
                renderer, cfg.data.batch_size))

    eval_fn = None
    if args.eval_every:
        if test_spec is not None and os.path.isdir(test_spec.data_roots[0]):
            # batched eval over the recipe's test split
            test_builder = TestBatchBuilder(
                build_dataset(test_spec, seed=cfg.seed), cfg, mesh_points)

            def eval_fn(tr: Trainer) -> dict:
                metric = ADDMetric(points_per_class=mesh_points,
                                   diameters=mesh_diameters,
                                   symmetric_classes=tuple(symmetric))
                m, _ = evaluate_dataset(tr, test_builder, metric,
                                        limit=args.eval_limit,
                                        progress_every=0)
                return {k: v for k, v in m.items()
                        if k.startswith("average/") or k == "num_instances"}
        else:
            # no test split on disk: masked on-device ADD(-S) over
            # synthetic jittered-GT batches (slot-aligned, no matching)
            def eval_fn(tr: Trainer) -> dict:
                evals = [shard_batch(synthetic_batch(
                    torch.Generator().manual_seed(7_777 + i), renderer,
                    cfg.data.batch_size)) for i in range(4)]
                return evaluate_device_accumulator(tr, evals, points,
                                                   num_classes)

    try:
        trainer.fit(get_batch, num_steps=cfg.optim.total_steps,
                    eval_every=args.eval_every, eval_fn=eval_fn,
                    panel_every=args.panel_every)
    finally:
        if batches is not None:
            batches.close()
        trainer.close()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
