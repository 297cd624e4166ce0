"""Training CLI of the port, the twin of the JAX package's ``train.py``
synthetic path: build the model, the renderer and the points bank, then
``Trainer.fit`` over synthetic batches with JSONL / TensorBoard logs,
image panels, checkpoints and (``--eval-every``) the on-device ADD(-S)
eval over 4 seeded synthetic batches.

  python -m scflow_torch.train --synthetic --steps 200 --work-dir work_dirs/smoke
  python -m scflow_torch.train --synthetic --device cpu --steps 2 \\
      --image-size 64 --num-classes 3 --batch-size 2

Synthetic scenes are the only data source until the BOP readers are
ported: the recipe and data flags (``--config``, ``--scene*``,
``--data-root``, ``--image-list``, ``--mesh-dir``, ``--mesh-ext``) are not
defined, so argparse refuses them.
"""
from __future__ import annotations

import argparse
import sys

import torch

from .data import synthetic_batch
from .rendering import Renderer, make_test_meshes
from .training import Config, build_points_bank
from .training.evaluate import evaluate_device_accumulator
from .training.trainer import Trainer


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m scflow_torch.train",
                                description="Train an SCFlow refiner on "
                                            "synthetic scenes")
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
                   help="train on synthetic scenes (the only data source "
                        "for now; accepted for the JAX CLI's command lines)")
    p.add_argument("--eval-every", type=int, default=None,
                   help="run the on-device ADD(-S) eval over 4 seeded "
                        "synthetic batches every N steps")
    p.add_argument("--panel-every", type=int, default=None,
                   help="dump train image panels (real|render|flows|mask) "
                        "every N steps into work_dir/images")
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu'")
    return p.parse_args(argv)


def resolve_config(args) -> Config:
    """The default config with the CLI's flags layered on top."""
    cfg = Config()
    m, o, d = cfg.model, cfg.optim, cfg.data
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
    return cfg


def main(argv=None) -> Trainer:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); returns the
    trainer after ``fit``."""
    args = parse_args(argv)
    cfg = resolve_config(args)
    size = cfg.data.image_scale
    bank = make_test_meshes(cfg.model.num_class, subdivisions=2,
                            device=args.device)
    renderer = Renderer(bank, image_size=(size, size))
    points = build_points_bank(bank, num_points=cfg.loss.num_loss_points)
    trainer = Trainer(cfg, renderer, points, device=args.device)
    if args.resume:
        trainer.resume()

    def get_batch(step: int) -> dict:
        return synthetic_batch(
            torch.Generator().manual_seed(cfg.seed * 1000_003 + step),
            renderer, cfg.data.batch_size)

    eval_fn = None
    if args.eval_every:
        # no test split on disk: masked on-device ADD(-S) over synthetic
        # jittered-GT batches (slot-aligned, no matching)
        def eval_fn(tr: Trainer) -> dict:
            batches = [synthetic_batch(
                torch.Generator().manual_seed(7_777 + i), renderer,
                cfg.data.batch_size) for i in range(4)]
            return evaluate_device_accumulator(tr, batches, points,
                                               cfg.model.num_class)

    try:
        trainer.fit(get_batch, num_steps=cfg.optim.total_steps,
                    eval_every=args.eval_every, eval_fn=eval_fn,
                    panel_every=args.panel_every)
    finally:
        trainer.close()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
