"""Synthetic pose-refinement batches (port of ``scflow_tpu/data/synthetic.py``).

The "real" image is a render at a random GT pose; the reference pose is
the GT pose under a clipped Gaussian SE(3) jitter. Every random number is
drawn from a ``torch.Generator`` on the CPU and the poses are computed
there, so one seed gives the same batch on the card and on the CPU; only
the render runs on the renderer's device.
"""
from __future__ import annotations

import math

import torch

from ..geometry.rotation import axis_angle_to_matrix, normalize, random_rotation
from ..geometry.se3 import matmul3
from ..rendering.renderer import Renderer
from ..training.config import JitterConfig


def default_intrinsics(image_size: tuple[int, int],
                       focal: float = 500.0) -> torch.Tensor:
    """(3, 3) pinhole intrinsics with the principal point at the centre."""
    h, w = image_size
    return torch.tensor([[focal, 0.0, w / 2.0], [0.0, focal, h / 2.0],
                         [0.0, 0.0, 1.0]], dtype=torch.float32)


def jitter_draws(generator: torch.Generator, n: int):
    """The jitter's standard normals: axis (n, 3), angle (n,), translation
    (n, 3)."""
    return (torch.randn(n, 3, generator=generator),
            torch.randn(n, generator=generator),
            torch.randn(n, 3, generator=generator))


def jitter_pose_core(rotations: torch.Tensor, translations: torch.Tensor,
                     axis_normal: torch.Tensor, angle_normal: torch.Tensor,
                     translation_normal: torch.Tensor, cfg: JitterConfig):
    """Deterministic part of :func:`jitter_pose`: a rotation about the
    normalised ``axis_normal`` by ``angle_normal``·angle_std (clipped to the
    angle limit), then translation offsets ``translation_normal``·(xy, xy,
    z std) shrunk onto the translation limit."""
    axis = normalize(axis_normal)
    limit = math.radians(cfg.angle_limit_deg)
    angle = (angle_normal * math.radians(cfg.angle_std_deg)).clamp(-limit,
                                                                   limit)
    r_delta = axis_angle_to_matrix(axis * angle[:, None])
    t_noise = translation_normal * translation_normal.new_tensor(
        [cfg.xy_std_mm, cfg.xy_std_mm, cfg.z_std_mm])
    t_norm = torch.linalg.vector_norm(t_noise, dim=-1, keepdim=True)
    scale = (cfg.translation_limit_mm / t_norm.clamp_min(1e-8)).clamp(max=1.0)
    return matmul3(r_delta, rotations), translations + t_noise * scale


def jitter_pose(generator: torch.Generator, rotations: torch.Tensor,
                translations: torch.Tensor, cfg: JitterConfig = JitterConfig()):
    """Gaussian SE(3) jitter of (N, 3, 3) / (N, 3) poses on the CPU."""
    return jitter_pose_core(rotations, translations,
                            *jitter_draws(generator, rotations.shape[0]), cfg)


def synthetic_batch(generator: torch.Generator, renderer: Renderer,
                    batch_size: int, jitter_cfg: JitterConfig = JitterConfig(),
                    depth_range: tuple = (500.0, 900.0)) -> dict:
    """One training batch on the renderer's device: real_images (N, H, W, 3)
    in [0, 1] (the default 0/255 normalisation), gt_masks (N, H, W) float,
    gt/ref rotations and translations, k (N, 3, 3) and labels (N,)."""
    h, w = renderer.image_size
    n = batch_size
    labels = torch.randint(0, renderer.mesh_bank.num_classes, (n,),
                           generator=generator)
    gt_r = random_rotation(generator, (n,))
    z = depth_range[0] + (depth_range[1] - depth_range[0]) * torch.rand(
        n, generator=generator)
    # near the principal axis, so the object stays in frame
    xy = torch.rand(n, 2, generator=generator) * 60.0 - 30.0
    gt_t = torch.cat([xy, z[:, None]], dim=-1)
    k = default_intrinsics((h, w)).expand(n, 3, 3).contiguous()
    ref_r, ref_t = jitter_pose(generator, gt_r, gt_t, jitter_cfg)

    dev = renderer.mesh_bank.device
    batch = {"gt_rotations": gt_r, "gt_translations": gt_t,
             "ref_rotations": ref_r, "ref_translations": ref_t, "k": k,
             "labels": labels}
    batch = {key: v.to(dev) for key, v in batch.items()}
    real = renderer(batch["gt_rotations"], batch["gt_translations"],
                    batch["k"], batch["labels"])
    batch["real_images"] = real["images"]
    batch["gt_masks"] = real["mask"].float()
    return batch
