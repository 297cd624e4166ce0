"""Pose visualisation: 3D boxes, pose axes, projected points, render
overlays (port of ``tools/visualize.py``), without cv2 or PIL: drawing by
``scflow_torch.tools.draw``, PNGs by ``utils.tb_writer.encode_png``,
renders by the port's ``Renderer`` (``VisTool`` with
``render_image=False``: K1's no-attribute form on the card;
``draw_pose_contour`` renders in full).

  python -m scflow_torch.tools.visualize --data-root D/test \\
      --ref-annots-root D/init_poses --image-list D/image_lists/test.txt \\
      --mesh-dir D/models [--index 0] [--out vis.png] [--device cpu]
"""
from __future__ import annotations

import argparse
import colorsys
import dataclasses
import os

import numpy as np
import torch

from . import draw

_BOX_EDGES = [(0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
              (0, 4), (1, 5), (2, 6), (3, 7)]


def project(points, k, r, t):
    """(P, 3) object points → (P, 2) pixel coordinates under pose (r, t)."""
    p = points @ r.T + t
    uvw = p @ k.T
    return uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-8)


def draw_3d_bbox(image, corners_3d, k, r, t, color=(0, 255, 0), thickness=2):
    """A copy of ``image`` with the projected 3D box (8 corners in
    ``bbox_corners`` order)."""
    img = np.ascontiguousarray(image.copy())
    pts = project(corners_3d, k, r, t).astype(int)
    for a, b in _BOX_EDGES:
        draw.line(img, pts[a], pts[b], color, thickness)
    return img


def draw_pose_axes(image, k, r, t, length=50.0, thickness=3):
    """A copy of ``image`` with the x, y, z axes at the object origin in
    red, green, blue."""
    img = np.ascontiguousarray(image.copy())
    pts = project(np.array([[0, 0, 0], [length, 0, 0], [0, length, 0],
                            [0, 0, length]], np.float32), k, r, t).astype(int)
    for i, color in enumerate([(0, 0, 255), (0, 255, 0), (255, 0, 0)]):
        draw.line(img, pts[0], pts[i + 1], color, thickness)
    return img


def draw_projected_points(image, points_3d, k, r, t, color=(255, 0, 0)):
    """A copy of ``image`` with a radius-1 dot at each projected point."""
    img = np.ascontiguousarray(image.copy())
    for x, y in project(points_3d, k, r, t).astype(int):
        draw.circle(img, (int(x), int(y)), 1, color)
    return img


def _render_masks(renderer, rotations, translations, ks, labels):
    dev = renderer.mesh_bank.device
    out = renderer(torch.as_tensor(np.asarray(rotations), dtype=torch.float32,
                                   device=dev),
                   torch.as_tensor(np.asarray(translations),
                                   dtype=torch.float32, device=dev),
                   torch.as_tensor(np.asarray(ks), dtype=torch.float32,
                                   device=dev),
                   torch.as_tensor(np.asarray(labels), dtype=torch.long,
                                   device=dev))
    return out["mask"].cpu().numpy()


def draw_pose_contour(image, renderer, k, r, t, label, color=(0, 255, 255),
                      thickness=2):
    """A copy of ``image`` with the outline of the object rendered at the
    pose (the reference's ``Pytorch3dVisTool`` contour, by the port's
    renderer)."""
    mask = _render_masks(renderer, np.asarray(r)[None], np.asarray(t)[None],
                         np.asarray(k)[None], [label])[0]
    img = np.ascontiguousarray(image.copy())
    return draw.draw_contours(img, draw.find_contours(mask), color, thickness)


def _class_color(label: int) -> tuple:
    """Deterministic per-class RGB color (golden-angle hue walk)."""
    h = (label * 0.61803398875) % 1.0
    r, g, b = colorsys.hsv_to_rgb(h, 0.85, 0.95)
    return (int(r * 255), int(g * 255), int(b * 255))


def draw_detections(image, rotations, translations, model_points, ks,
                    labels=None, scores=None, num_points=512, thickness=2):
    """Class-colored 3D box, projected point cloud and score text per
    detection (reference ``draw_detections``, tools/visualize.py:87-156).

    image (H, W, 3) uint8 RGB; rotations (N, 3, 3), translations (N, 3);
    model_points (V, 3) shared or a list of per-instance (V, 3); ks
    (N, 3, 3); labels (N,) class ids for the colors (default red); scores
    (N,) drawn as text at the box's top."""
    img = np.ascontiguousarray(image.copy())
    rng = np.random.default_rng(0)
    for i in range(len(rotations)):
        pts = (model_points[i] if isinstance(model_points, (list, tuple))
               else model_points)
        color = (_class_color(int(labels[i])) if labels is not None
                 else (255, 0, 0))
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        c = pts.mean(axis=0)
        ext = (hi - lo) / 2.0
        corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                            for sz in (-1, 1)], np.float32) * ext + c
        img = draw_3d_bbox(img, corners, ks[i], rotations[i], translations[i],
                           color=color, thickness=thickness)
        choose = rng.choice(len(pts), min(num_points, len(pts)),
                            replace=False)
        img = draw_projected_points(img, pts[choose], ks[i], rotations[i],
                                    translations[i], color=color)
        if scores is not None:
            uv = project(corners, ks[i], rotations[i],
                         translations[i]).astype(int)
            org = (int(uv[:, 0].min()), max(int(uv[:, 1].min()) - 4, 12))
            draw.put_text(img, f"{float(scores[i]):.2f}", org, color)
    return img


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image as a PNG (its directory made)."""
    from ..utils.tb_writer import encode_png

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(img)))


class VisTool:
    """Batch mask or contour overlay at predicted poses (reference
    ``Pytorch3dVisTool``, tools/visualize.py:582-640), rendered depth and
    mask only (``render_image=False``).

    ``vis_mode``: 'mask' (0.5-alpha class-colored masks) or 'contour'."""

    def __init__(self, renderer, vis_mode: str = "mask", score_thr: float = 0.0,
                 contour_size: int = 3):
        if vis_mode not in ("mask", "contour"):
            raise ValueError(f"vis_mode must be 'mask' or 'contour', got "
                             f"{vis_mode!r}")
        self.renderer = dataclasses.replace(renderer, render_image=False)
        self.vis_mode = vis_mode
        self.score_thr = score_thr
        self.contour_size = contour_size

    def __call__(self, image, rotations, translations, labels, ks,
                 scores=None, out_file=None):
        if len(rotations) == 0:
            return image
        keep = (np.asarray(scores) > self.score_thr if scores is not None
                else np.ones(len(rotations), bool))
        rotations, translations = rotations[keep], translations[keep]
        labels, ks = labels[keep], ks[keep]
        masks = _render_masks(self.renderer, rotations, translations, ks,
                              labels)
        img = np.ascontiguousarray(image.copy())   # never mutate the input
        if self.vis_mode == "mask":
            colored = np.zeros_like(img)
            for m, lab in zip(masks, labels):
                colored[m] = _class_color(int(lab))
            img = (img * 0.5 + colored * 0.5).astype(np.uint8)
        else:
            for m, lab in zip(masks, labels):
                draw.draw_contours(img, draw.find_contours(m),
                                   _class_color(int(lab)), self.contour_size)
        if out_file is not None:
            write_png(out_file, img)
        return img


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description="Render pose overlays for a BOP "
                                            "image")
    p.add_argument("--data-root", required=True)
    p.add_argument("--ref-annots-root", required=True)
    p.add_argument("--image-list", required=True)
    p.add_argument("--mesh-dir", required=True)
    p.add_argument("--mesh-ext", default="ply")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--out", default="vis.png")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..data.bop import RefineDataset
    from ..rendering import Renderer, load_mesh_dir
    from ..training.config import YCBV_CLASS_NAMES

    dataset = RefineDataset(args.data_root, args.ref_annots_root,
                            args.image_list, class_names=YCBV_CLASS_NAMES)
    item = dataset[args.index]
    if item is None:
        raise ValueError(f"image {args.index} has no object to draw")
    bank = load_mesh_dir(args.mesh_dir, ext=args.mesh_ext, device=args.device)
    img = item["image"]
    renderer = Renderer(bank, image_size=img.shape[:2])
    for i in range(len(item["labels"])):
        img = draw_pose_contour(img, renderer, item["ori_k"],
                                item["ref_rotations"][i],
                                item["ref_translations"][i],
                                int(item["labels"][i]))
        img = draw_pose_axes(img, item["ori_k"], item["ref_rotations"][i],
                             item["ref_translations"][i])
    write_png(args.out, img)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
