"""What a run feeds both sides, made from ``--seed`` on the device: the
meshes, the weights, the loss points and the pools of batches.

Every draw comes from a ``torch.Generator`` on the run's device, one
stream per purpose, so one seed gives the same inputs in every run, and
different seeds give the same sizes and the same amount of work."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..reference.geometry.rotation import (axis_angle_to_matrix, normalize,
                                           quaternion_to_matrix)
from ..reference.geometry.se3 import matmul3
from ..reference.rendering.renderer import MeshTables, render

# one generator stream per purpose, so that adding a draw to one leaves
# the others as they were
STREAMS = {"meshes": 1, "weights": 2, "points": 3, "pool": 4}
# the seeded init's scale of the pose head's output layers (a pose that
# barely moves per iteration, as a trained refiner's does)
POSE_OUT_SCALE = 0.01
IDENTITY_6D = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)


def generator(seed: int, stream: str, device) -> torch.Generator:
    """The generator of one purpose for ``seed`` (any whole number)."""
    mixed = (int(seed) * 8 + STREAMS[stream]) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def icosphere(subdivisions: int, radius: float):
    """(verts (V, 3) f32, faces (F, 3) int64) of an icosphere: 20·4^s
    faces, outward winding."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = [np.array(v, np.float64) for v in (
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t],
        [0, 1, t], [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1],
        [-t, 0, -1], [-t, 0, 1])]
    faces = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
             [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
             [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
             [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    for _ in range(subdivisions):
        cache: dict = {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                cache[key] = len(verts)
                verts.append((verts[a] + verts[b]) / 2.0)
            return cache[key]

        new = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        faces = new
    v = np.stack(verts)
    v = v / np.linalg.norm(v, axis=-1, keepdims=True) * radius
    return v.astype(np.float32), np.asarray(faces, np.int64)


def make_meshes(cfg: dict, seed: int, device) -> dict:
    """Per-class meshes of the configuration's ``mesh`` entry: verts,
    faces, unit vertex normals (the sphere's own) and colors drawn from
    the seed, each (C, ...) on ``device``."""
    spec, c = cfg["mesh"], cfg["model"]["num_class"]
    v, f = icosphere(spec["subdivisions"], spec["radius_mm"])
    if f.shape[0] != spec["faces"]:
        raise ValueError(f"icosphere of {spec['subdivisions']} subdivisions "
                         f"has {f.shape[0]} faces, not {spec['faces']}")
    verts = torch.from_numpy(v).to(device).expand(c, -1, -1).contiguous()
    faces = torch.from_numpy(f).to(device).expand(c, -1, -1).contiguous()
    normals = verts / spec["radius_mm"]
    lo, hi = spec["color_range"]
    colors = lo + (hi - lo) * torch.rand(verts.shape,
                                         generator=generator(seed, "meshes",
                                                             device),
                                         device=device)
    return {"verts": verts, "faces": faces, "normals": normals,
            "colors": colors, "diameter": 2.0 * spec["radius_mm"]}


def mesh_tables(meshes: dict) -> MeshTables:
    return MeshTables.build(meshes["verts"], meshes["faces"],
                            meshes["normals"], meshes["colors"])


def make_weights(model: torch.nn.Module, seed: int, device) -> dict:
    """A state dict for ``model``'s names: conv and linear weights
    N(0, 1/fan_in) from one draw (the pose head's outputs 100× smaller),
    biases 0, norms at identity, the rotation bias at the identity
    rotation, batch-norm statistics 0 / 1."""
    conv_like = (torch.nn.Conv2d, torch.nn.Linear)
    owners = {f"{mn}.{pn}" if mn else pn: m
              for mn, m in model.named_modules()
              for pn, _ in m.named_parameters(recurse=False)}
    drawn = [(n, p) for n, p in model.named_parameters()
             if n.endswith("weight") and isinstance(owners[n], conv_like)]
    flat = torch.randn(sum(p.numel() for _, p in drawn),
                       generator=generator(seed, "weights", device),
                       device=device)
    state, at = {}, 0
    for n, p in drawn:
        std = 1.0 / math.sqrt(p[0].numel())
        if ".rotation_pred." in n or ".translation_pred." in n:
            std *= POSE_OUT_SCALE
        state[n] = flat[at:at + p.numel()].view(p.shape) * std
        at += p.numel()
    for n, p in model.named_parameters():
        if n in state:
            continue
        if n.endswith("rotation_pred.bias"):
            state[n] = torch.tensor(IDENTITY_6D, device=device).repeat(
                p.numel() // len(IDENTITY_6D))
        elif n.endswith("weight"):          # norm scales
            state[n] = torch.ones(p.shape, device=device)
        else:
            state[n] = torch.zeros(p.shape, device=device)
    for n, b in model.named_buffers():
        if n.endswith("running_var"):
            state[n] = torch.ones(b.shape, device=device)
        else:
            state[n] = torch.zeros(b.shape, dtype=b.dtype, device=device)
    return state


def make_points(cfg: dict, meshes: dict, seed: int, device) -> dict:
    """The pose loss's points: ``loss.num_loss_points`` vertices drawn per
    class, all valid; diameters, symmetric classes as configured."""
    c, v = meshes["verts"].shape[:2]
    p = cfg["loss"]["num_loss_points"]
    idx = torch.randint(0, v, (c, p), device=device,
                        generator=generator(seed, "points", device))
    cls = torch.arange(c, device=device)[:, None]
    sym = torch.zeros(c, dtype=torch.bool, device=device)
    sym[list(cfg["symmetric_classes"])] = True
    return {"points": meshes["verts"][cls, idx],
            "valid": torch.ones(c, p, dtype=torch.bool, device=device),
            "diameters": torch.full((c,), meshes["diameter"], device=device),
            "symmetric": sym}


def jitter(gen, rotations, translations, j: dict):
    """A clipped Gaussian SE(3) jitter of GT poses into reference poses."""
    n, dev = rotations.shape[0], rotations.device
    axis = normalize(torch.randn(n, 3, generator=gen, device=dev))
    limit = math.radians(j["angle_limit_deg"])
    angle = (torch.randn(n, generator=gen, device=dev)
             * math.radians(j["angle_std_deg"])).clamp(-limit, limit)
    noise = torch.randn(n, 3, generator=gen, device=dev) * torch.tensor(
        [j["xy_std_mm"], j["xy_std_mm"], j["z_std_mm"]], device=dev)
    norm = torch.linalg.vector_norm(noise, dim=-1, keepdim=True)
    scale = (j["translation_limit_mm"] / norm.clamp_min(1e-8)).clamp(max=1.0)
    return (matmul3(axis_angle_to_matrix(axis * angle[:, None]), rotations),
            translations + noise * scale)


def make_pool(cfg: dict, traffic: dict, tables: MeshTables, seed: int,
              device) -> list:
    """``traffic['pool']`` batches of ``traffic['batch']`` objects: labels
    uniform over the classes, uniform GT rotations, GT translations in the
    traffic's box, reference poses jittered from them, and the real crops
    rendered at the GT pose as uint8 (with the GT masks)."""
    gen = generator(seed, "pool", device)
    n, c = traffic["batch"], cfg["model"]["num_class"]
    h, w = cfg["image_size"]
    (z0, z1), xy = traffic["gt_depth_mm"], traffic["gt_xy_mm"]
    f = traffic["focal_px"]
    k = torch.tensor([[f, 0.0, w / 2.0], [0.0, f, h / 2.0],
                      [0.0, 0.0, 1.0]], device=device).expand(n, 3, 3)
    pool = []
    for _ in range(traffic["pool"]):
        labels = torch.randint(0, c, (n,), generator=gen, device=device)
        gt_r = quaternion_to_matrix(torch.randn(n, 4, generator=gen,
                                                device=device))
        z = z0 + (z1 - z0) * torch.rand(n, generator=gen, device=device)
        gt_xy = (torch.rand(n, 2, generator=gen, device=device) * 2.0 - 1.0) * xy
        gt_t = torch.cat([gt_xy, z[:, None]], dim=-1)
        ref_r, ref_t = jitter(gen, gt_r, gt_t, traffic["jitter"])
        real = render(tables, gt_r, gt_t, k, labels, (h, w))
        batch = {"real_images": (real["images"] * 255.0).round().to(
                     torch.uint8),
                 "ref_rotations": ref_r, "ref_translations": ref_t,
                 "k": k.contiguous(), "labels": labels}
        if traffic["step"] == "train":
            batch.update(gt_rotations=gt_r, gt_translations=gt_t,
                         gt_masks=real["mask"].float())
        pool.append(batch)
    return pool
