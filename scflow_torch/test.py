"""Evaluation CLI of the port, the twin of the JAX package's ``test.py``:
refine the initial poses of a BOP test split (a RefineDataset: BOP layout
plus an initial-pose root) in packed batches on one device, compute
ADD(-S) / AUC / REP with the exact ``ADDMetric``, and optionally write
BOP-format results (``--save-dir``, ``--format-only``).

  python -m scflow_torch.test --data-root DATA/test \\
      --ref-annots-root DATA/init_poses --image-list DATA/image_lists/test.txt \\
      --mesh-dir DATA/models [--device cpu] [--checkpoint DIR]

With ``--num-classes 21`` (the default) the YCB-V symmetric classes and
mesh diameters apply, whatever the meshes, as in the JAX CLI. The recipe
flag ``--config`` and the scene pose-graph flag ``--pose-graph`` are not
defined, so argparse refuses them: the recipes come with the
training-data slice, the pose graph with the parallel slice.
"""
from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m scflow_torch.test",
                                description="Evaluate an SCFlow refiner on "
                                            "a BOP test split")
    p.add_argument("--checkpoint", required=False, default=None,
                   help="a directory of the port's checkpoints (the newest "
                        "is restored)")
    p.add_argument("--torch-checkpoint", default=None,
                   help="reference torch .pth (raw state_dict or mmengine "
                        "checkpoint) loaded into the model")
    p.add_argument("--work-dir", default="work_dirs/scflow")
    p.add_argument("--data-root", default=None)
    p.add_argument("--ref-annots-root", default=None)
    p.add_argument("--image-list", default=None)
    p.add_argument("--mesh-dir", default=None)
    p.add_argument("--mesh-ext", default="ply")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--passes", type=int, default=1,
                   help="multi-pass refinement (re-render between passes)")
    p.add_argument("--num-classes", type=int, default=21)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--slot-budget", type=int, default=16,
                   help="object slots per packed device batch (several "
                        "images share one batch)")
    p.add_argument("--exact-eval", action="store_true",
                   help="disable the low-res pose-flow eval fast path "
                        "(ModelConfig.lowres_eval) for exactness checks")
    p.add_argument("--eval", action="store_true", default=True)
    p.add_argument("--format-only", action="store_true")
    p.add_argument("--save-dir", default=None)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> tuple[dict, list]:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); returns the
    metric dict and the per-image results (kept when results are written)."""
    args = parse_args(argv)
    for field in ("data_root", "ref_annots_root", "image_list", "mesh_dir"):
        if getattr(args, field) is None:
            raise SystemExit(f"--{field.replace('_', '-')} is required")

    from .data.bop import RefineDataset
    from .data.loader import TestBatchBuilder
    from .metrics import ADDMetric, format_metric_table, write_bop_results
    from .rendering import Renderer, load_mesh_dir
    from .training import (YCBV_CLASS_NAMES, YCBV_MESH_DIAMETERS,
                           YCBV_SYMMETRIC_CLASSES, Config, DataConfig,
                           ModelConfig, RenderConfig, build_points_bank)
    from .training.evaluate import evaluate_dataset
    from .training.trainer import Trainer

    size = args.image_size
    cfg = Config(model=ModelConfig(num_class=args.num_classes,
                                   iters=args.iters, test_iters=args.iters,
                                   test_passes=args.passes,
                                   lowres_eval=not args.exact_eval),
                 render=RenderConfig(image_size=(size, size)),
                 data=DataConfig(image_scale=size),
                 work_dir=args.work_dir)
    bank = load_mesh_dir(args.mesh_dir, ext=args.mesh_ext, device=args.device)
    symmetric = YCBV_SYMMETRIC_CLASSES if args.num_classes == 21 else ()
    diameters = YCBV_MESH_DIAMETERS if args.num_classes == 21 else None
    renderer = Renderer(bank, image_size=(size, size))
    points = build_points_bank(bank, symmetric_classes=symmetric,
                               diameters=diameters, num_points=1000)
    trainer = Trainer(cfg, renderer, points, device=args.device)
    if args.checkpoint:
        trainer.resume(args.checkpoint)
    if args.torch_checkpoint:
        report = trainer.load_torch_checkpoint(args.torch_checkpoint)
        print(f"loaded torch checkpoint {args.torch_checkpoint}: "
              f"{len(report['covered'])} tensors loaded, "
              f"{len(report['missing'])} kept at init")

    dataset = RefineDataset(args.data_root, args.ref_annots_root,
                            args.image_list, class_names=YCBV_CLASS_NAMES)
    mesh_points = list(points.points.cpu().numpy())
    builder = TestBatchBuilder(dataset, cfg, mesh_points)
    metric = ADDMetric(points_per_class=mesh_points,
                       diameters=points.diameters.cpu().numpy(),
                       symmetric_classes=tuple(symmetric),
                       class_names=YCBV_CLASS_NAMES)
    write = bool(args.save_dir or args.format_only)
    metrics, results = evaluate_dataset(
        trainer, builder, metric, slot_budget=args.slot_budget,
        limit=args.limit, collect_results=write)

    if write:
        save_dir = args.save_dir or f"{args.work_dir}/bop_results"
        paths = write_bop_results(results, save_dir)
        print(f"wrote {len(paths)} BOP scene files to {save_dir}")
    if not args.format_only and metrics:
        print(format_metric_table(metrics))
        for k in sorted(metrics):
            if k.startswith(("average/", "instance/")) or k == "num_instances":
                print(f"{k}: {metrics[k]}")
    return metrics, results


if __name__ == "__main__":
    main(sys.argv[1:])
