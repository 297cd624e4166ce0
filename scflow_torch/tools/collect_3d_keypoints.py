"""Per-class 3D keypoints of a mesh directory → a JSON file (port of
``tools/collect_3d_keypoints.py``): 8 keypoints per mesh as axis-aligned
box corners, oriented (PCA) box corners, or farthest-point samples.

  python -m scflow_torch.tools.collect_3d_keypoints --mesh-dir D/models \\
      --out D/keypoints/bbox.json [--mode bbox|obbox|fps] [--num 8]
"""
from __future__ import annotations

import argparse
import json
import os
from glob import glob

import numpy as np


def bbox_corners(verts: np.ndarray) -> np.ndarray:
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    return np.array([[x, y, z] for x in (lo[0], hi[0])
                     for y in (lo[1], hi[1]) for z in (lo[2], hi[2])],
                    np.float32)


def oriented_bbox_corners(verts: np.ndarray) -> np.ndarray:
    """Corners of the box aligned with the principal axes."""
    mean = verts.mean(axis=0)
    centered = verts - mean
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    corners = bbox_corners(centered @ vt.T)
    return (corners @ vt + mean).astype(np.float32)


def farthest_point_sample(verts: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """Farthest-point sampling from a seeded first point."""
    rng = np.random.default_rng(seed)
    sel = [int(rng.integers(len(verts)))]
    d = np.linalg.norm(verts - verts[sel[0]], axis=1)
    for _ in range(k - 1):
        idx = int(np.argmax(d))
        sel.append(idx)
        d = np.minimum(d, np.linalg.norm(verts - verts[idx], axis=1))
    return verts[sel].astype(np.float32)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--mesh-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--mode", choices=["bbox", "obbox", "fps"], default="bbox")
    p.add_argument("--num", type=int, default=8)
    p.add_argument("--ext", default="ply")
    args = p.parse_args(argv)

    from ..rendering.mesh import load_mesh_file

    out = {}
    for path in sorted(glob(os.path.join(args.mesh_dir, f"*.{args.ext}"))):
        label = int(os.path.basename(path).split(".")[0].split("_")[-1])
        verts = np.asarray(load_mesh_file(path)["verts"])
        if args.mode == "bbox":
            kp = bbox_corners(verts)
        elif args.mode == "obbox":
            kp = oriented_bbox_corners(verts)
        else:
            kp = farthest_point_sample(verts, args.num)
        out[str(label)] = kp.tolist()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(f"wrote keypoints for {len(out)} meshes to {args.out}")
    return out


if __name__ == "__main__":
    main()
