"""The scene pose graph with and without (port of
``tools/pose_graph_ablation.py``): on a synthetic multi-object BOP set
whose initial poses share a per-image camera error, train SCFlow briefly
on crops of the set through the train loader, then evaluate it through
``evaluate_dataset`` per object, with the camera-only graph and with the
full graph, and write the three ADD tables to ``--out`` (markdown) and
beside it as JSON.

  python -m scflow_torch.tools.pose_graph_ablation --out work_dirs/pg.md \\
      [--steps 2000] [--num-images 48] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

# the JAX tool's fixed sizes: train batch, the generated frames
BATCH_SIZE, HEIGHT, WIDTH = 16, 480, 640


def main(argv=None) -> dict:
    """Run the ablation; returns {per-object, camera-only, full graph}
    metric dicts."""
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True, help="the markdown table's path")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--num-images", type=int, default=48)
    p.add_argument("--num-classes", type=int, default=4)
    p.add_argument("--camera-angle-std", type=float, default=1.5)
    p.add_argument("--camera-trans-std", type=float, default=10.0)
    p.add_argument("--image-scale", type=int, default=128)
    p.add_argument("--work-dir", default="work_dirs/pose_graph_ablation")
    p.add_argument("--data-root", default=None,
                   help="reuse an existing generated set")
    p.add_argument("--eval-only", action="store_true",
                   help="skip training; resume the newest checkpoint of "
                        "--work-dir (requires --data-root)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..data.bop import RefineDataset, SuperviseTrainDataset
    from ..data.loader import TestBatchBuilder, TrainBatchBuilder, prefetch
    from ..metrics import ADDMetric
    from ..rendering import Renderer, load_mesh_dir
    from ..training import (Config, DataConfig, ModelConfig, OptimConfig,
                            RenderConfig, build_points_bank)
    from ..training.evaluate import evaluate_dataset
    from ..training.trainer import Trainer
    from . import make_synthetic_bop

    root = args.data_root
    if root is None:
        root = tempfile.mkdtemp(prefix="pgabl_")
        make_synthetic_bop.main([
            "--out", root, "--num-images", str(args.num_images),
            "--num-classes", str(args.num_classes), "--min-objects", "3",
            "--max-objects", "6", "--height", str(HEIGHT),
            "--width", str(WIDTH),
            "--camera-angle-std", str(args.camera_angle_std),
            "--camera-trans-std", str(args.camera_trans_std),
            "--device", args.device])
        print(f"generated set at {root}", flush=True)

    nc = args.num_classes
    cfg = Config(model=ModelConfig(num_class=nc, iters=4, test_iters=4),
                 optim=OptimConfig(lr=2e-4, total_steps=args.steps),
                 data=DataConfig(batch_size=BATCH_SIZE,
                                 image_scale=args.image_scale),
                 render=RenderConfig(image_size=(args.image_scale,
                                                 args.image_scale)),
                 work_dir=args.work_dir)
    bank = load_mesh_dir(os.path.join(root, "models"), device=args.device)
    sz = args.image_scale
    renderer = Renderer(bank, image_size=(sz, sz))
    points = build_points_bank(bank, num_points=512)
    trainer = Trainer(cfg, renderer, points, device=args.device)

    names = tuple(chr(ord("a") + i) for i in range(nc))
    train_ds = SuperviseTrainDataset(
        os.path.join(root, "test"),
        os.path.join(root, "image_lists", "test.txt"),
        class_names=names, min_visib_fract=0.1)
    mesh_points = [points.points[c].cpu().numpy() for c in range(nc)]
    diameters = points.diameters.cpu().numpy()
    if args.eval_only:
        trainer.resume()
        print("resumed the newest checkpoint (eval only)", flush=True)
    else:
        builder = TrainBatchBuilder(train_ds, cfg, mesh_points,
                                    list(diameters), seed=0)
        batches = prefetch(builder, num_prefetch=6, num_workers=4)
        print(f"training {args.steps} steps on crops...", flush=True)
        trainer.fit(batches, num_steps=args.steps)
        batches.close()
    ds = RefineDataset(os.path.join(root, "test"),
                       os.path.join(root, "init_poses"),
                       os.path.join(root, "image_lists", "test.txt"),
                       class_names=names)
    test_builder = TestBatchBuilder(ds, cfg, mesh_points)

    def make_metric():
        return ADDMetric(points_per_class=mesh_points, diameters=diameters,
                         class_names=names)

    plain, pg_cam, pg_full = make_metric(), make_metric(), make_metric()
    metrics, _ = evaluate_dataset(trainer, test_builder, plain,
                                  slot_budget=16, progress_every=16,
                                  pose_graph_metric=pg_cam,
                                  pose_graph_camera_only=True)
    cam_metrics = pg_cam.compute()
    evaluate_dataset(trainer, test_builder, make_metric(), slot_budget=16,
                     progress_every=0, pose_graph_metric=pg_full,
                     pose_graph_camera_only=False)
    full_metrics = pg_full.compute()

    rows = []
    for k in sorted(k for k in metrics
                    if any(t in k for t in ("add_", "auc", "num_instances"))):
        vals = (metrics.get(k), cam_metrics.get(k), full_metrics.get(k))
        if all(isinstance(v, (int, float, np.floating, np.integer))
               for v in vals):
            rows.append((k, *(float(v) for v in vals)))
    print(f"\n{'metric':28s} {'per-object':>11s} {'cam-only':>9s} "
          f"{'full-graph':>11s}")
    for k, a, b, c in rows:
        print(f"{k:28s} {a:11.4f} {b:9.4f} {c:11.4f}")
    lines = [
        "# Pose-graph extension: with and without (synthetic BOP ablation)",
        "",
        f"`python -m scflow_torch.tools.pose_graph_ablation`: "
        f"{args.num_images} images, {nc} classes, 3-6 objects per image, a "
        f"shared per-image camera error (rotation std "
        f"{args.camera_angle_std} deg, translation std "
        f"{args.camera_trans_std} mm) on every initial pose; SCFlow (4 "
        f"iterations, {sz} px) trained {args.steps} steps on crops of the "
        "set; evaluated by `evaluate_dataset(pose_graph_metric=...)`, the "
        "path of `test.py --pose-graph`.",
        "",
        "| metric | per-object | + camera-only graph | + full graph |",
        "|---|---|---|---|",
        *(f"| {k} | {a:.4f} | {b:.4f} | {c:.4f} |" for k, a, b, c in rows),
        "",
    ]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines))
    result = {"plain": {k: a for k, a, _, _ in rows},
              "camera_only": {k: b for k, _, b, _ in rows},
              "full_graph": {k: c for k, _, _, c in rows}}
    with open(os.path.splitext(args.out)[0] + ".json", "w") as f:
        json.dump(result, f)
    print(f"\nwrote {args.out}")
    return result


if __name__ == "__main__":
    main()
