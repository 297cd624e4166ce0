"""Inference step: normalise → render → refine → last-iteration pose (port
of the SCFlow eval path of ``scflow_tpu/training/steps.py``).

``make_eval_step`` and ``make_multi_pass_eval_step`` return plain functions
of one batch dict that run under ``torch.inference_mode()`` on the device
they were built for. Batches may hold numpy arrays or tensors, in the JAX
layout: real_images (N, H, W, 3) uint8 or normalised float, ref_rotations
(N, 3, 3), ref_translations (N, 3), k (N, 3, 3), labels (N,).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.heads import identity_rotation_bias
from ..models.layers import FusedInstanceNorm
from ..models.refiner import SCFlowRefiner
from ..rendering.renderer import Renderer
from .config import Config

# seeded init: the pose head's output layers start 100× smaller than the
# rest (the JAX init zeroes them, which would leave the pose unmoved)
POSE_OUT_SCALE = 0.01


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init on the CPU: conv/linear weights N(0, 1/fan_in), biases 0,
    norms at identity (BN running stats 0/1), pose-head rotation bias at
    the identity rotation."""
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = 1.0 / math.sqrt(m.weight[0].numel())
                if name.endswith(("rotation_pred", "translation_pred")):
                    std *= POSE_OUT_SCALE
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator) * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (FusedInstanceNorm, nn.GroupNorm,
                                nn.BatchNorm2d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()
        head = model.decoder.pose_pred
        head.rotation_pred.bias.copy_(identity_rotation_bias(head.num_class))


def build_model(cfg: Config, device: str | torch.device = "cuda",
                seed: int = 0) -> SCFlowRefiner:
    """SCFlowRefiner for ``cfg`` (float32), initialised from ``seed`` with a ``torch.Generator`` on the CPU, on ``device`` in
    eval mode. Real weights come in through ``weights.load_jax_variables``
    or ``load_state_dict``."""
    dev = resolve_device(device)
    m = cfg.model
    with torch.device("meta"):
        model = SCFlowRefiner(
            num_class=m.num_class, h_channels=m.h_channels,
            cxt_channels=m.cxt_channels, feat_channels=m.feat_channels,
            num_levels=m.num_levels, radius=m.radius, iters=m.iters,
            image_size=tuple(cfg.render.image_size))
    model.to_empty(device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def render_at_pose(renderer: Renderer, rotations, translations, k, labels,
                   normalize_mean, normalize_std):
    """Render and normalise: (images (N, H, W, 3), depth (N, H, W), mask
    (N, H, W) float); mean/std are on the 0-255 scale."""
    out = renderer(rotations, translations, k, labels)
    dev = out["depth"].device
    mean = torch.tensor(normalize_mean, dtype=torch.float32, device=dev) / 255.0
    std = torch.tensor(normalize_std, dtype=torch.float32, device=dev) / 255.0
    images = (out["images"] - mean) / std
    return images, out["depth"], out["mask"].float()


def device_normalize_images(images: torch.Tensor, cfg: Config) -> torch.Tensor:
    """(u8 − mean)/std on the device for uint8 crops; float images pass."""
    if images.dtype == torch.uint8:
        mean = torch.tensor(cfg.data.normalize_mean, dtype=torch.float32,
                            device=images.device)
        std = torch.tensor(cfg.data.normalize_std, dtype=torch.float32,
                           device=images.device)
        return (images.float() - mean) / std
    return images


def _to_device(v, dev: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    return torch.from_numpy(np.array(v)).to(dev)


def _eval_step_core(model: SCFlowRefiner, renderer: Renderer, cfg: Config,
                    dev: torch.device):

    @torch.inference_mode()
    def eval_step(batch: dict) -> dict:
        batch = {k: _to_device(v, dev) for k, v in batch.items()}
        real = device_normalize_images(batch["real_images"], cfg)
        labels = batch["labels"].long()
        rendered, depth, _ = render_at_pose(
            renderer, batch["ref_rotations"], batch["ref_translations"],
            batch["k"], labels, cfg.data.normalize_mean,
            cfg.data.normalize_std)
        outputs = model(rendered, real, batch["ref_rotations"],
                        batch["ref_translations"], depth, batch["k"], labels,
                        iters=cfg.model.test_iters,
                        lowres=cfg.model.lowres_eval)
        return {
            "rotations": outputs.rotations[-1],
            "translations": outputs.translations[-1],
            "masks": outputs.masks[-1],
            "flow": outputs.flow_from_pred[-1],
            "depth": depth,
            "ref_rotations": batch["ref_rotations"],
            "ref_translations": batch["ref_translations"],
        }

    return eval_step


def make_eval_step(model: SCFlowRefiner, renderer: Renderer, cfg: Config,
                   device: str | torch.device = "cuda"):
    """Inference step on ``device``: render at the reference pose, refine,
    return the last iteration's pose. Moves ``model`` (in place) and the
    renderer's mesh bank to the device; raises if CUDA is asked for and
    absent."""
    dev = resolve_device(device)
    model.to(dev).eval()
    renderer = dataclasses.replace(renderer,
                                   mesh_bank=renderer.mesh_bank.to(dev))
    return _eval_step_core(model, renderer, cfg, dev)


def make_multi_pass_eval_step(model: SCFlowRefiner, renderer: Renderer,
                              cfg: Config, passes: int = 2,
                              device: str | torch.device = "cuda"):
    """Refine, re-render at the refined pose, refine again (``passes``
    times in all)."""
    step = make_eval_step(model, renderer, cfg, device)

    def multi_pass_step(batch: dict) -> dict:
        out = None
        for _ in range(passes):
            out = step(batch)
            batch = dict(batch, ref_rotations=out["rotations"],
                         ref_translations=out["translations"])
        return out

    return multi_pass_step
