"""Write a synthetic BOP-format dataset to disk with the port (the twin of
the JAX package's ``tools/make_synthetic_bop.py``: the same flags, draws,
layout and files).

Renders procedural meshes into full-frame scenes with the port's
``Renderer`` on ``--device`` and writes a complete BOP layout — rgb/,
mask_visib/, scene_gt.json, scene_camera.json, scene_gt_info.json, PLY
models, an image list, and an init_poses root with jittered initial poses —
so the eval path (readers → crops → refinement → ADD metric → BOP writer)
runs without external data. PNGs are written by the stdlib encoder
(``utils.tb_writer.encode_png``), so neither cv2 nor PIL is needed.

As in the JAX tool, the scenes are rendered in the bank's default gray
albedo (its meshes carry their colors under a key the bank does not read),
while the PLY files carry the random vertex colors.

Usage:
  python -m scflow_torch.tools.make_synthetic_bop --out /tmp/minibop \\
      --num-images 8 --device cpu
  python -m scflow_torch.test --device cpu --data-root /tmp/minibop/test \\
      --ref-annots-root /tmp/minibop/init_poses \\
      --image-list /tmp/minibop/image_lists/test.txt \\
      --mesh-dir /tmp/minibop/models --num-classes 3
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def write_ply(path, verts, faces, colors=None):
    """ASCII PLY with optional per-vertex uchar colors."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for i, v in enumerate(verts):
            line = f"{v[0]:.4f} {v[1]:.4f} {v[2]:.4f}"
            if colors is not None:
                c = (np.clip(colors[i], 0, 1) * 255).astype(int)
                line += f" {c[0]} {c[1]} {c[2]}"
            f.write(line + "\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def _imwrite(path, img):
    from ..utils.tb_writer import encode_png

    with open(path, "wb") as f:
        f.write(encode_png(img))


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m scflow_torch.tools.make_synthetic_bop",
        description="Write a synthetic BOP dataset with the port's renderer")
    p.add_argument("--out", required=True)
    p.add_argument("--num-images", type=int, default=8)
    p.add_argument("--num-classes", type=int, default=3)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--max-objects", type=int, default=3)
    p.add_argument("--min-objects", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--split", default="test")
    # correlated per-image camera error composed onto every object's INIT
    # pose (on top of per-object jitter): gives multi-object scenes a
    # shared correction for the pose-graph extension to recover
    p.add_argument("--camera-angle-std", type=float, default=0.0,
                   help="per-image shared rotation error std (deg)")
    p.add_argument("--camera-trans-std", type=float, default=0.0,
                   help="per-image shared translation error std (mm)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Write the dataset; returns counts: images, objects, classes."""
    from scipy.spatial.transform import Rotation

    from ..data.pipeline import jitter_pose_np
    from ..device import resolve_device
    from ..rendering import Renderer, box, build_mesh_bank, icosphere
    from ..training.config import JitterConfig

    args = parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    # procedural meshes (same family as make_test_meshes) + PLY export
    meshes, colors = [], []
    for i in range(args.num_classes):
        if i % 2 == 0:
            v, f = icosphere(subdivisions=2, radius=60.0 * (1 + 0.2 * i))
        else:
            v, f = box(extents=(90.0, 60.0, 42.0))
        colors.append(np.asarray(0.35 + 0.55 * rng.random((len(v), 3)),
                                 np.float32))
        meshes.append({"verts": np.asarray(v, np.float32),
                       "faces": np.asarray(f, np.int32)})

    models_dir = os.path.join(args.out, "models")
    os.makedirs(models_dir, exist_ok=True)
    for i, (m, c) in enumerate(zip(meshes, colors)):
        write_ply(os.path.join(models_dir, f"obj_{i + 1:06d}.ply"),
                  m["verts"], m["faces"], c)

    h, w = args.height, args.width
    renderer = Renderer(build_mesh_bank(meshes, device=dev), image_size=(h, w),
                        background_color=(0.0, 0.0, 0.0))
    k = np.array([[572.4, 0, w / 2.0], [0, 572.4, h / 2.0], [0, 0, 1]],
                 np.float32)

    seq = "000001"
    split_dir = os.path.join(args.out, args.split, seq)
    os.makedirs(os.path.join(split_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(split_dir, "mask_visib"), exist_ok=True)
    init_dir = os.path.join(args.out, "init_poses", seq)
    os.makedirs(init_dir, exist_ok=True)
    lists_dir = os.path.join(args.out, "image_lists")
    os.makedirs(lists_dir, exist_ok=True)

    scene_gt, scene_cam, scene_info, init_gt = {}, {}, {}, {}
    lines = []
    jit_cfg = JitterConfig(angle_std_deg=10.0, xy_std_mm=10.0, z_std_mm=30.0)
    objects = 0

    for img_id in range(args.num_images):
        n = int(rng.integers(args.min_objects, args.max_objects + 1))
        labels = rng.integers(0, args.num_classes, n)
        rots, trans = [], []
        for _ in range(n):
            rots.append(Rotation.random(
                random_state=int(rng.integers(1 << 30))).as_matrix())
            trans.append([rng.uniform(-120, 120), rng.uniform(-80, 80),
                          rng.uniform(700, 1100)])
        rots = np.asarray(rots, np.float32)
        trans = np.asarray(trans, np.float32)

        with torch.inference_mode():
            out = renderer(torch.from_numpy(rots).to(dev),
                           torch.from_numpy(trans).to(dev),
                           torch.from_numpy(k).to(dev).expand(n, 3, 3),
                           torch.from_numpy(labels).to(dev))
            rgb = out["images"].cpu().numpy()          # (n, H, W, 3)
            depth = out["depth"].cpu().numpy()

        # z-composite the per-object renders into one scene image
        d = np.where(depth > 0, depth, np.inf)
        winner = np.argmin(d, axis=0)            # (H, W)
        any_fg = np.isfinite(d.min(axis=0))
        scene = np.zeros((h, w, 3), np.float32)
        vis_masks = []
        for i in range(n):
            own = (winner == i) & any_fg & (depth[i] > 0)
            scene[own] = rgb[i][own]
            vis_masks.append(own)
        scene = np.clip(scene * 255.0, 0, 255).astype(np.uint8)
        scene[~any_fg] = rng.integers(0, 255, 3)  # flat random bg color

        _imwrite(os.path.join(split_dir, "rgb", f"{img_id:06d}.png"), scene)
        gt_list, info_list, init_list = [], [], []
        if args.camera_angle_std > 0 or args.camera_trans_std > 0:
            aa = rng.normal(0, np.deg2rad(args.camera_angle_std), 3)
            cam_dr = Rotation.from_rotvec(aa).as_matrix().astype(np.float32)
            cam_dt = rng.normal(0, args.camera_trans_std, 3).astype(np.float32)
        for i in range(n):
            m8 = (vis_masks[i] * 255).astype(np.uint8)
            _imwrite(os.path.join(split_dir, "mask_visib",
                                  f"{img_id:06d}_{i:06d}.png"), m8)
            full = int((depth[i] > 0).sum())
            vis = int(vis_masks[i].sum())
            ys, xs = np.nonzero(vis_masks[i])
            bbox = ([int(xs.min()), int(ys.min()),
                     int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1)]
                    if len(xs) else [0, 0, 0, 0])
            gt_list.append({"cam_R_m2c": rots[i].reshape(-1).tolist(),
                            "cam_t_m2c": trans[i].tolist(),
                            "obj_id": int(labels[i]) + 1})
            info_list.append({"visib_fract": vis / max(full, 1),
                              "px_count_visib": vis,
                              "bbox_obj": bbox, "bbox_visib": bbox})
            ref_r, ref_t, *_ = jitter_pose_np(rng, rots[i], trans[i], jit_cfg)
            if args.camera_angle_std > 0 or args.camera_trans_std > 0:
                # shared per-image camera error (drawn once per image above)
                ref_r = cam_dr @ np.asarray(ref_r)
                ref_t = cam_dr @ np.asarray(ref_t) + cam_dt
            init_list.append({"cam_R_m2c": np.asarray(ref_r).reshape(-1).tolist(),
                              "cam_t_m2c": np.asarray(ref_t).tolist(),
                              "obj_id": int(labels[i]) + 1, "score": 1.0})
        objects += n
        scene_gt[str(img_id)] = gt_list
        scene_info[str(img_id)] = info_list
        scene_cam[str(img_id)] = {"cam_K": k.reshape(-1).tolist(),
                                  "depth_scale": 1.0}
        init_gt[str(img_id)] = init_list
        lines.append(f"{seq}/rgb/{img_id:06d}.png")

    for path, obj in ((os.path.join(split_dir, "scene_gt.json"), scene_gt),
                      (os.path.join(split_dir, "scene_camera.json"), scene_cam),
                      (os.path.join(split_dir, "scene_gt_info.json"),
                       scene_info),
                      (os.path.join(init_dir, "scene_gt.json"), init_gt)):
        with open(path, "w") as f:
            json.dump(obj, f)
    with open(os.path.join(lists_dir, f"{args.split}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.num_images} images, {args.num_classes} models "
          f"to {args.out}")
    return {"images": args.num_images, "objects": objects,
            "classes": args.num_classes}


if __name__ == "__main__":
    main(sys.argv[1:])
