"""BOP-format result writer (a copy of ``scflow_tpu/metrics/bop_writer.py``;
the reference's ``format_results`` / ``scene_gt.json`` emitter,
metrics/add.py:402-453 + datasets/utils.py:39-68).

Groups per-image predictions by scene and writes one compact
``scene_gt.json`` per sequence under ``save_dir``, in the BOP pose format
(cam_R_m2c row-major 9-list, cam_t_m2c 3-list, obj_id 1-based).
"""
from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np


def write_bop_results(results: list[dict], save_dir: str) -> list[str]:
    """Write predictions grouped by scene.

    Each result dict: scene_id, img_id, labels (n,), rotations (n,3,3),
    translations (n,3), optional scores (n,).

    Returns the list of written file paths.
    """
    by_scene: dict[int, dict] = defaultdict(dict)
    for res in results:
        objs = []
        n = len(res["labels"])
        for i in range(n):
            obj = {
                "cam_R_m2c": np.asarray(res["rotations"][i], np.float64)
                .reshape(-1).tolist(),
                "cam_t_m2c": np.asarray(res["translations"][i], np.float64)
                .reshape(-1).tolist(),
                "obj_id": int(res["labels"][i]) + 1,
            }
            if "scores" in res:
                obj["score"] = float(res["scores"][i])
            objs.append(obj)
        by_scene[int(res["scene_id"])][str(int(res["img_id"]))] = objs

    paths = []
    for scene_id, frames in sorted(by_scene.items()):
        scene_dir = os.path.join(save_dir, f"{scene_id:06d}")
        os.makedirs(scene_dir, exist_ok=True)
        path = os.path.join(scene_dir, "scene_gt.json")
        with open(path, "w") as f:
            json.dump(frames, f, separators=(",", ":"))
        paths.append(path)
    return paths
