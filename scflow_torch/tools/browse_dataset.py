"""Dataset browser (port of ``tools/browse_dataset.py``): GT and reference
poses drawn as projected mesh points and pose axes on full images, and
with ``--patch`` on the cropped training patches, written as PNGs to
``--out-dir``; without cv2 or PIL. ``--synthetic`` renders scenes on
``--device`` (no data needed); else a BOP train split from disk.

  python -m scflow_torch.tools.browse_dataset --synthetic --out-dir OUT [--device cpu]
  python -m scflow_torch.tools.browse_dataset --data-root D/train_real \\
      --image-list D/image_lists/train_real.txt --mesh-dir D/models \\
      [--patch] --num 10 --out-dir OUT
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .visualize import draw_pose_axes, draw_projected_points, write_png


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Browse dataset pipeline output")
    p.add_argument("--out-dir", default="work_dirs/browse")
    p.add_argument("--num", type=int, default=8)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--patch", action="store_true",
                   help="also write the cropped training patches")
    p.add_argument("--data-root", default=None)
    p.add_argument("--image-list", default=None)
    p.add_argument("--mesh-dir", default=None)
    p.add_argument("--mesh-ext", default="ply")
    p.add_argument("--num-classes", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def browse_synthetic(args) -> list:
    from ..data import synthetic_batch
    from ..rendering import Renderer, make_test_meshes

    bank = make_test_meshes(num_classes=args.num_classes, subdivisions=2,
                            radius=60.0, device=args.device)
    renderer = Renderer(bank, image_size=(256, 256))
    gen = torch.Generator().manual_seed(args.seed)
    batch = {k: v.cpu().numpy()
             for k, v in synthetic_batch(gen, renderer, args.num).items()}
    imgs = np.clip(batch["real_images"] * 255.0, 0, 255).astype(np.uint8)
    paths = []
    for i in range(args.num):
        img = np.ascontiguousarray(imgs[i])
        k, label = batch["k"][i], int(batch["labels"][i])
        verts = bank.verts[label].cpu().numpy()
        # GT pose in green dots, reference (jittered) pose in red dots
        img = draw_projected_points(img, verts[::7], k, batch["gt_rotations"][i],
                                    batch["gt_translations"][i],
                                    color=(0, 255, 0))
        img = draw_projected_points(img, verts[::7], k, batch["ref_rotations"][i],
                                    batch["ref_translations"][i],
                                    color=(255, 0, 0))
        img = draw_pose_axes(img, k, batch["gt_rotations"][i],
                             batch["gt_translations"][i], length=40.0)
        paths.append(os.path.join(args.out_dir, f"synthetic_{i:03d}.png"))
        write_png(paths[-1], img)
    print(f"wrote {args.num} panels to {args.out_dir}")
    return paths


def browse_disk(args) -> list:
    from ..data.bop import SuperviseTrainDataset
    from ..data.pipeline import crop_resize_pad, jitter_pose_np, project_bbox
    from ..rendering import load_mesh_dir
    from ..training.config import YCBV_CLASS_NAMES, Config

    cfg = Config()
    bank = load_mesh_dir(args.mesh_dir, ext=args.mesh_ext, device="cpu")
    dataset = SuperviseTrainDataset(args.data_root, args.image_list,
                                    class_names=YCBV_CLASS_NAMES,
                                    seed=args.seed)
    rng = np.random.default_rng(args.seed)
    paths, wrote = [], 0
    for idx in range(len(dataset)):
        if wrote >= args.num:
            break
        item = dataset[idx]
        if item is None:
            continue
        img = np.ascontiguousarray(item["image"])
        for i in range(len(item["labels"])):
            label = int(item["labels"][i])
            k = item["k"][i]
            r, t = item["gt_rotations"][i], item["gt_translations"][i]
            verts = bank.verts[label].numpy()
            img = draw_projected_points(img, verts[::17], k, r, t,
                                        color=(0, 255, 0))
            img = draw_pose_axes(img, k, r, t, length=40.0)
            if args.patch:
                ref_r, ref_t, *_ = jitter_pose_np(rng, r, t, cfg.jitter)
                bbox = project_bbox(verts, k, ref_r, ref_t)
                crop = crop_resize_pad(img, bbox, k, cfg.data.image_scale,
                                       size_ratio=1.1)
                patch = draw_projected_points(
                    np.ascontiguousarray(crop.patch), verts[::17],
                    crop.k_new, r, t, color=(0, 255, 0))
                paths.append(os.path.join(args.out_dir,
                                          f"patch_{wrote:03d}_{i}.png"))
                write_png(paths[-1], patch)
        paths.append(os.path.join(args.out_dir, f"img_{wrote:03d}.png"))
        write_png(paths[-1], img)
        wrote += 1
    print(f"wrote {wrote} panels to {args.out_dir}")
    return paths


def main(argv=None) -> list:
    """Write the panels; returns their paths."""
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    if args.synthetic or not args.data_root:
        return browse_synthetic(args)
    return browse_disk(args)


if __name__ == "__main__":
    main()
