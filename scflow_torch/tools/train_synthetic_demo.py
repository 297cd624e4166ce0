"""Learning demo (port of ``tools/train_synthetic_demo.py``): train on
synthetic scenes rendered on the device and show that refinement beats
the initial poses on held-out scenes; prints ADD (mm) and the rotation
error (degrees) before and after. No data needed.

  python -m scflow_torch.tools.train_synthetic_demo [--steps 2500] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

# the JAX tool's fixed sizes: batch, square frame side, held-out batches
BATCH_SIZE, IMAGE_SIZE, EVAL_BATCHES = 16, 128, 4


def main(argv=None) -> dict:
    """Train and evaluate; returns the before/after means."""
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=2500)
    p.add_argument("--work-dir", default="work_dirs/synthetic_demo")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..data import synthetic_batch
    from ..geometry import add_error, rotation_angle_deg
    from ..rendering import Renderer, make_test_meshes
    from ..training import (Config, DataConfig, ModelConfig, OptimConfig,
                            RenderConfig, build_points_bank)
    from ..training.trainer import Trainer

    n, size = BATCH_SIZE, IMAGE_SIZE
    cfg = Config(model=ModelConfig(num_class=3, iters=4, test_iters=4),
                 optim=OptimConfig(lr=2e-4, total_steps=args.steps),
                 data=DataConfig(batch_size=n, image_scale=size),
                 render=RenderConfig(image_size=(size, size)),
                 work_dir=args.work_dir)
    bank = make_test_meshes(num_classes=3, subdivisions=2, radius=60.0,
                            device=args.device)
    renderer = Renderer(bank, image_size=(size, size))
    points = build_points_bank(bank, num_points=512)
    trainer = Trainer(cfg, renderer, points, device=args.device)
    dev = bank.device

    def batch(seed):
        return synthetic_batch(torch.Generator().manual_seed(seed),
                               renderer, n)

    def eval_now():
        init_add, ref_add, init_rot, ref_rot = [], [], [], []
        for i in range(EVAL_BATCHES):
            b = batch(999_000 + i)
            out = trainer.predict({k: b[k] for k in (
                "real_images", "ref_rotations", "ref_translations", "k",
                "labels")})
            pts = points.points[b["labels"]]
            r = torch.as_tensor(out["rotations"], device=dev)
            t = torch.as_tensor(out["translations"], device=dev)
            init_add += add_error(b["ref_rotations"], b["ref_translations"],
                                  b["gt_rotations"], b["gt_translations"],
                                  pts).tolist()
            ref_add += add_error(r, t, b["gt_rotations"], b["gt_translations"],
                                 pts).tolist()
            init_rot += rotation_angle_deg(b["ref_rotations"],
                                           b["gt_rotations"]).tolist()
            ref_rot += rotation_angle_deg(r, b["gt_rotations"]).tolist()
        return tuple(float(np.mean(v)) for v in (init_add, ref_add, init_rot,
                                                 ref_rot))

    before = eval_now()
    print("BEFORE: init ADD {:.2f}mm -> refined ADD {:.2f}mm | rot {:.2f} -> "
          "{:.2f} deg".format(*before), flush=True)
    trainer.fit(lambda step: batch(7_000_003 + step), num_steps=args.steps)
    after = eval_now()
    print(f"AFTER {args.steps} steps: init ADD {after[0]:.2f}mm -> refined "
          f"ADD {after[1]:.2f}mm | rot {after[2]:.2f} -> {after[3]:.2f} deg",
          flush=True)
    return {"before": before, "after": after}


if __name__ == "__main__":
    main()
