"""Twins of the entry points of the JAX package's ``__graft_entry__.py``:
the flagship forward step with its example arguments, and a dry run of
the full data-parallel train step over n processes.

  python -m scflow_torch.graft_entry [--device cpu] [--ranks N]
"""
from __future__ import annotations

import argparse
import dataclasses
import math

import torch

from .data import synthetic_batch
from .device import resolve_device
from .parallel.mesh import shard_batch, spawn
from .rendering import Renderer, make_test_meshes
from .training import (Config, DataConfig, LossConfig, ModelConfig,
                       OptimConfig, RenderConfig, build_model,
                       build_points_bank, make_optimizer, make_train_step)
from .training.steps import normalization, render_at_pose


def _flagship(num_class: int = 21, image_size=(256, 256), batch: int = 2,
              iters: int = 8, mesh_subdiv: int = 2,
              device: str | torch.device = "cuda"):
    """The flagship SCFlow refiner, its renderer and a synthetic batch."""
    cfg = Config(model=ModelConfig(num_class=num_class, iters=iters,
                                   test_iters=iters),
                 render=RenderConfig(image_size=tuple(image_size)))
    bank = make_test_meshes(num_class, subdivisions=mesh_subdiv, radius=60.0,
                            device=device)
    renderer = Renderer(bank, image_size=tuple(image_size))
    batch_data = synthetic_batch(torch.Generator().manual_seed(0), renderer,
                                 batch)
    model = build_model(cfg, device=device, seed=1)
    return cfg, renderer, model, batch_data


def entry(device: str | torch.device = "cuda"):
    """(forward step on the flagship model, example_args): the forward
    renders at the reference pose with the mesh bank it is given and
    refines (eval mode, 8 iterations), returning the last iteration's
    (rotations, translations)."""
    cfg, renderer, model, batch = _flagship(device=device)
    norm = normalization(cfg, resolve_device(device))

    @torch.inference_mode()
    def forward(real_images, ref_rotations, ref_translations, k, labels,
                mesh_bank):
        model.eval()
        rend = dataclasses.replace(renderer, mesh_bank=mesh_bank)
        rendered, depth, _ = render_at_pose(rend, ref_rotations,
                                            ref_translations, k, labels, *norm)
        out = model(rendered, real_images, ref_rotations, ref_translations,
                    depth, k, labels)
        return out.rotations[-1], out.translations[-1]

    example_args = (batch["real_images"], batch["ref_rotations"],
                    batch["ref_translations"], batch["k"], batch["labels"],
                    renderer.mesh_bank)
    return forward, example_args


def _dryrun_step(n: int, device) -> float:
    """One full train step at 64², 4 classes on this process's shard of a
    global batch of 2 per process whose last slot ``sample_valid`` masks
    (the BN sample mask and the weighted losses); returns the loss."""
    dev = resolve_device(device)
    if dev.type == "cuda":             # this rank's card
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = Config(model=ModelConfig(num_class=4, iters=2, test_iters=2),
                 loss=LossConfig(num_loss_points=64),
                 optim=OptimConfig(total_steps=100),
                 data=DataConfig(batch_size=2 * n),
                 render=RenderConfig(image_size=(64, 64)))
    bank = make_test_meshes(4, subdivisions=1, radius=60.0, device=dev)
    renderer = Renderer(bank, image_size=(64, 64))
    points = build_points_bank(bank, symmetric_classes=(1,), num_points=64)
    model = build_model(cfg, device=dev, seed=1)
    step = make_train_step(model, renderer, points, cfg,
                           make_optimizer(cfg, model.parameters()), device=dev)
    batch = synthetic_batch(torch.Generator().manual_seed(0), renderer, 2 * n)
    valid = torch.ones(2 * n, device=dev)
    valid[-1] = 0.0
    loss = float(step(shard_batch(dict(batch, sample_valid=valid)))["loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip({n}): non-finite loss {loss}")
    return loss


def dryrun_multichip(n_devices: int, device: str = "cuda") -> float:
    """Run the full train step data-parallel over ``n_devices`` spawned
    processes, a group even of one, and check its loss: gloo ranks on the
    CPU, NCCL ranks on CUDA, one per card (``n_devices`` ≤ the card
    count). Returns the global loss (every rank's)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"need {n_devices} GPUs, have "
                         f"{torch.cuda.device_count()}")
    losses = spawn(_dryrun_step, n_devices, (n_devices, device),
                   device=device)
    if len(set(losses)) != 1:
        raise RuntimeError(f"ranks disagree on the loss: {losses}")
    print(f"dryrun_multichip({n_devices}): ok, loss={losses[0]:.4f}")
    return losses[0]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m scflow_torch.graft_entry")
    p.add_argument("--device", default="cuda")
    p.add_argument("--ranks", type=int, default=1)
    args = p.parse_args(argv)
    dryrun_multichip(args.ranks, device=args.device)
    fn, example = entry(device=args.device)
    print("entry forward ok:", [tuple(o.shape) for o in fn(*example)])


if __name__ == "__main__":
    main()
