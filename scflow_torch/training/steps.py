"""Train and eval steps (port of ``scflow_tpu/training/steps.py``) for
both model families: SCFlow (pose from the refiner's loop, f32 or bf16)
and RAFT flow(+occlusion) (pose from RANSAC-EPnP on the last flow).

Eval: normalise → render → refine → last-iteration pose (RAFT: flow →
``solve_pose_from_flow`` with a generator seeded 0 on every call, the JAX
package's fixed key, and ``pnp_valid``).
``make_eval_step`` and ``make_multi_pass_eval_step`` return plain functions
of one batch dict that run under ``torch.inference_mode()`` on the device
they were built for.

Train: render at the reference pose → ``scflow_loss`` (RAFT:
``raft_loss``) → backward → the optax recipe's global-norm clip and AdamW with the linear OneCycle
schedule. ``make_train_step`` and ``make_multi_cycle_train_step`` update
the model and the optimizer in place and return the step's metrics.
Under a process group (``parallel.mesh``) the train steps are
data-parallel, each process on its shard of the global batch: batch norm
and the losses' batch means take global statistics, the gradients are
summed before the clip and the metrics are summed, so every process
applies the update of the global batch.

Batches may hold numpy arrays or tensors, in the JAX layout: real_images
(N, H, W, 3) uint8 or normalised float, ref_rotations (N, 3, 3),
ref_translations (N, 3), k (N, 3, 3), labels (N,); training adds
gt_rotations, gt_translations, gt_masks (N, H, W) and optionally
sample_valid (N,).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..geometry.flow import filter_flow_by_mask, flow_from_pose_and_depth
from ..losses import sequence_flow_loss, sequence_mask_loss, sequence_pose_loss
from ..models.flow_pose import solve_pose_from_flow
from ..models.decoder import DEPTH_TRANSFORMS
from ..models.encoder import ARCH
from ..models.heads import ROT_DIM, identity_rotation_bias
from ..models.layers import FusedInstanceNorm
from ..models.refiner import RAFTRefiner, SCFlowRefiner
from ..parallel.collect import all_reduce_grads_, reduce_metrics
from ..rendering.renderer import Renderer
from ..utils.profiling import span
from .config import Config, OptimConfig
from .points_bank import PointsBank

# seeded init: the pose head's output layers start 100× smaller than the
# rest (the JAX init zeroes them, which would leave the pose unmoved)
POSE_OUT_SCALE = 0.01


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init on the CPU: conv/linear weights N(0, 1/fan_in), biases 0,
    norms at identity (BN running stats 0/1), an SCFlow pose-head rotation
    bias at the identity rotation."""
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
        if isinstance(model, SCFlowRefiner):
            head = model.decoder.pose_pred
            head.rotation_pred.bias.copy_(
                identity_rotation_bias(head.rotation_mode, head.num_class))


_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def build_model(cfg: Config, device: str | torch.device = "cuda",
                seed: int = 0) -> SCFlowRefiner | RAFTRefiner:
    """The refiner of ``cfg.model.family``: ``SCFlowRefiner`` ('scflow', in
    ``cfg.model.dtype``) or ``RAFTRefiner`` ('raft_flow', and
    'raft_flow_mask' with the occlusion head; float32 whatever the dtype,
    as in the JAX package), initialised from ``seed`` with a
    ``torch.Generator`` on the CPU, on ``device`` in eval mode. Every
    ``ModelConfig`` field goes through as the JAX ``build_model`` passes
    it; a value neither package runs raises ``ValueError`` naming the
    field. Real weights come in through ``weights.load_jax_variables`` or
    ``load_state_dict``."""
    dev = resolve_device(device)
    m = cfg.model
    for field, value, allowed in (
            ("dtype", m.dtype, tuple(_DTYPES)),
            ("family", m.family, ("scflow", "raft_flow", "raft_flow_mask")),
            ("net_type", m.net_type, tuple(ARCH)),
            ("rotation_mode", m.rotation_mode, tuple(ROT_DIM)),
            ("depth_transform", m.depth_transform, DEPTH_TRANSFORMS)):
        if value not in allowed:
            raise ValueError(f"ModelConfig.{field}: unknown value {value!r} "
                             f"(one of {allowed})")
    if m.family != "scflow" and m.net_type == "Large":
        # RAFT's decoder upsamples by 8: flows of a stride-4 encoder would
        # come out at twice the frame (the JAX model's do, and its steps
        # then fail on the shapes)
        raise ValueError("ModelConfig.net_type: 'Large' (stride 4) does not "
                         f"fit the RAFT decoder's ×8 upsampling ({m.family})")
    with torch.device("meta"):
        if m.family in ("raft_flow", "raft_flow_mask"):
            model = RAFTRefiner(
                separate_encoder=m.separate_encoder,
                h_channels=m.h_channels, cxt_channels=m.cxt_channels,
                feat_channels=m.feat_channels, net_type=m.net_type,
                num_levels=m.num_levels, radius=m.radius, iters=m.iters,
                predict_mask=m.family == "raft_flow_mask")
        else:
            model = SCFlowRefiner(
                num_class=m.num_class, separate_encoder=m.separate_encoder,
                h_channels=m.h_channels, cxt_channels=m.cxt_channels,
                feat_channels=m.feat_channels, net_type=m.net_type,
                num_levels=m.num_levels, radius=m.radius, iters=m.iters,
                rotation_mode=m.rotation_mode,
                depth_transform=m.depth_transform,
                detach_depth_for_xy=m.detach_depth_for_xy,
                mask_flow=m.mask_flow, mask_corr=m.mask_corr, remat=m.remat,
                image_size=tuple(cfg.render.image_size),
                dtype=_DTYPES[m.dtype])
    model.to_empty(device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def normalization(cfg: Config, device: str | torch.device):
    """``cfg``'s normalisation mean and std (0-255 scale) as f32 tensors on
    ``device``. The steps make them once, when they are built: a tensor
    made from host values inside a step would wait for the device."""
    return tuple(torch.tensor(v, dtype=torch.float32, device=device)
                 for v in (cfg.data.normalize_mean, cfg.data.normalize_std))


def render_at_pose(renderer: Renderer, rotations, translations, k, labels,
                   normalize_mean, normalize_std):
    """Render and normalise: (images (N, H, W, 3), depth (N, H, W), mask
    (N, H, W) float); mean/std are on the 0-255 scale, tuples or the
    tensors of :func:`normalization`."""
    out = renderer(rotations, translations, k, labels)
    dev = out["depth"].device
    mean = torch.as_tensor(normalize_mean, dtype=torch.float32,
                           device=dev) / 255.0
    std = torch.as_tensor(normalize_std, dtype=torch.float32,
                          device=dev) / 255.0
    images = (out["images"] - mean) / std
    return images, out["depth"], out["mask"].float()


def device_normalize_images(images: torch.Tensor, norm) -> torch.Tensor:
    """(u8 − mean)/std on the device for uint8 crops; float images pass.
    ``norm``: the (mean, std) of :func:`normalization`, or a ``Config``
    (whose constants are then copied from the host)."""
    if images.dtype == torch.uint8:
        if isinstance(norm, Config):
            norm = normalization(norm, images.device)
        mean, std = norm
        return (images.float() - mean) / std
    return images


def _to_device(v, dev: torch.device) -> torch.Tensor:
    """A batch entry on ``dev``; host arrays go to a CUDA device through
    pinned memory without waiting for it."""
    if isinstance(v, torch.Tensor):
        t = v
    else:
        t = torch.from_numpy(np.array(v))
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _eval_step_core(model: SCFlowRefiner | RAFTRefiner, renderer: Renderer,
                    cfg: Config, dev: torch.device):
    norm = normalization(cfg, dev)

    @torch.inference_mode()
    def eval_step(batch: dict) -> dict:
        with span("step"):
            # a train step in between leaves the model in train mode
            model.eval()
            with span("inputs"):
                batch = {k: _to_device(v, dev) for k, v in batch.items()}
                real = device_normalize_images(batch["real_images"], norm)
            labels = batch["labels"].long()
            with span("render"):
                rendered, depth, _ = render_at_pose(
                    renderer, batch["ref_rotations"],
                    batch["ref_translations"], batch["k"], labels, *norm)
            if isinstance(model, RAFTRefiner):
                flows, masks = model(rendered, real,
                                     iters=cfg.model.test_iters)
                with span("pnp"):
                    solved = solve_pose_from_flow(
                        torch.Generator(device=dev).manual_seed(0), flows[-1],
                        masks[-1][..., 0], depth, batch["ref_rotations"],
                        batch["ref_translations"], batch["k"])
                return {
                    "rotations": solved["rotations"],
                    "translations": solved["translations"],
                    "masks": masks[-1],
                    "flow": flows[-1],
                    "depth": depth,
                    "ref_rotations": batch["ref_rotations"],
                    "ref_translations": batch["ref_translations"],
                    "pnp_valid": solved["valid"],
                }
            outputs = model(rendered, real, batch["ref_rotations"],
                            batch["ref_translations"], depth, batch["k"],
                            labels, iters=cfg.model.test_iters,
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


def make_eval_step(model: SCFlowRefiner | RAFTRefiner, renderer: Renderer,
                   cfg: Config, device: str | torch.device = "cuda"):
    """Inference step on ``device``: render at the reference pose, refine,
    return the last iteration's pose (RAFT: the PnP pose of the last flow,
    the reference pose where PnP fails, and ``pnp_valid``). Moves ``model`` (in place) and the
    renderer's mesh bank to the device; raises if CUDA is asked for and
    absent."""
    dev = resolve_device(device)
    model.to(dev).eval()
    renderer = dataclasses.replace(renderer,
                                   mesh_bank=renderer.mesh_bank.to(dev))
    return _eval_step_core(model, renderer, cfg, dev)


def make_multi_pass_eval_step(model: SCFlowRefiner | RAFTRefiner,
                              renderer: Renderer,
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


def make_panel_step(model: SCFlowRefiner, renderer: Renderer, cfg: Config,
                    device: str | torch.device = "cuda"):
    """Observability step on ``device``: refine a train batch in eval mode
    without gradients and return sample 0's panel arrays (real | render |
    gt/pose/pred flow | mask, HWC) and the per-iteration EPE vector (T,)
    over the pixels with a valid GT flow inside the render mask (the
    device side of the reference's TensorboardImgLoggerHook + eval_seq_epe).
    SCFlow only: a RAFT model has no in-loop pose (ValueError)."""
    if isinstance(model, RAFTRefiner):
        raise ValueError("panels use in-loop poses (SCFlow family)")
    dev = resolve_device(device)
    model.to(dev)
    renderer = dataclasses.replace(renderer,
                                   mesh_bank=renderer.mesh_bank.to(dev))
    max_flow = cfg.model.max_flow
    norm = normalization(cfg, dev)
    mean, std = (v / 255.0 for v in norm)

    @torch.inference_mode()
    def panel_step(batch: dict) -> dict:
        model.eval()
        batch = {k: _to_device(v, dev) for k, v in batch.items()}
        batch["real_images"] = device_normalize_images(batch["real_images"],
                                                       norm)
        rendered, depth, rmask = render_at_pose(
            renderer, batch["ref_rotations"], batch["ref_translations"],
            batch["k"], batch["labels"].long(), *norm)
        real, gt_flow, _ = _loss_targets(dict(batch, rendered_depths=depth),
                                         cfg)
        outputs = model(rendered, real, batch["ref_rotations"],
                        batch["ref_translations"], depth, batch["k"],
                        batch["labels"].long())
        valid = ((torch.linalg.vector_norm(gt_flow, dim=-1) < max_flow)
                 & (rmask > 0.5))
        w = valid.float()
        err = torch.linalg.vector_norm(outputs.flow_from_pred - gt_flow[None],
                                       dim=-1)              # (T, N, H, W)
        epe = (err * w[None]).sum((1, 2, 3)) / w.sum().clamp_min(1.0)
        return {
            "real": real[0] * std + mean,
            "render": rendered[0] * std + mean,
            "gt_flow": gt_flow[0],
            "pose_flow": outputs.flow_from_pose[-1, 0],
            "pred_flow": outputs.flow_from_pred[-1, 0],
            "mask": outputs.masks[-1, 0, ..., 0],
            "epe_per_iter": epe,
        }

    return panel_step


def onecycle_lr(step: int, optim: OptimConfig) -> float:
    """The learning rate of update ``step`` (from 0) under
    ``optax.linear_onecycle_schedule(transition_steps=max(total_steps,
    100), peak_value=lr, pct_start, pct_final=1 − pct_start, div_factor,
    final_div_factor)``: three linear pieces, lr/div → lr over
    [0, pct_start·T), lr → lr/div until pct_final·T, then → lr/div/final
    at T, and that value after."""
    total = max(optim.total_steps, 100)
    bounds = (0, int(optim.pct_start * total),
              int((1.0 - optim.pct_start) * total), total)
    values = [optim.lr / optim.div_factor]
    for scale in (optim.div_factor, 1.0 / optim.div_factor,
                  1.0 / optim.final_div_factor):
        values.append(values[-1] * scale)
    for b0, b1, v0, v1 in zip(bounds, bounds[1:], values, values[1:]):
        if b0 <= step < b1:
            return (v1 - v0) * ((step - b0) / (b1 - b0)) + v0
    return values[-1]


def make_optimizer(cfg: Config, params) -> torch.optim.AdamW:
    """AdamW over ``params`` with the recipe's betas, eps and weight decay
    (one group: biases and norm scales decay too, as in optax's ``adamw``).
    The train steps clip the gradients and set each update's learning rate
    from :func:`onecycle_lr` before ``step()``."""
    o = cfg.optim
    return torch.optim.AdamW(params, lr=onecycle_lr(0, o), betas=o.betas,
                             eps=o.eps, weight_decay=o.weight_decay)


def clip_by_global_norm_(grads: list[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: where the global norm is
    not below ``max_norm``, g ← (g / ‖g‖)·max_norm, in that order (without
    a host sync). Returns the norm before the clip."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one,
                                           torch.full_like(norm, max_norm)))
    return norm


def _updates_done(optimizer: torch.optim.Optimizer) -> int:
    """Updates the optimizer has applied (AdamW's per-parameter step count,
    a CPU tensor: reading it does not wait for the device)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state:
                return int(state["step"])
    return 0


def _loss_targets(batch: dict, cfg: Config):
    """(normalised real images, GT flow, occlusion target) of a train
    batch: GT flow from the reference and GT poses and the rendered depth,
    filtered by the GT mask; the occlusion target is the raw channel sum of
    the GT flow below ``max_flow``, as the reference computes it."""
    max_flow = cfg.model.max_flow
    real = device_normalize_images(batch["real_images"], cfg)
    gt_masks = batch.get("gt_masks")
    if gt_masks is not None and gt_masks.dtype == torch.uint8:
        gt_masks = gt_masks.float()
    gt_flow = flow_from_pose_and_depth(
        batch["ref_rotations"], batch["ref_translations"],
        batch["gt_rotations"], batch["gt_translations"],
        batch["rendered_depths"], batch["k"], invalid_num=max_flow)
    if cfg.model.filter_invalid_flow and gt_masks is not None:
        gt_flow = filter_flow_by_mask(gt_flow, gt_masks, invalid_num=max_flow)
    gt_occ = (gt_flow.sum(-1) < max_flow).float()
    return real, gt_flow, gt_occ


def scflow_loss(model: SCFlowRefiner, batch: dict, points_bank: PointsBank,
                cfg: Config, train: bool = True):
    """Full SCFlow training loss: (loss, metrics, outputs).

    ``batch`` is a train batch on the model's device plus rendered_images,
    rendered_depths and rendered_masks at the reference pose. ``train``
    sets the model's mode: in train mode the context encoder's BN uses
    batch statistics (excluding samples whose ``sample_valid`` is 0) and
    updates its running statistics in place. Targets: see
    :func:`_loss_targets`."""
    real, gt_flow, gt_occ = _loss_targets(batch, cfg)
    sample_valid = batch.get("sample_valid")
    labels = batch["labels"].long()
    model.train(train)
    outputs = model(batch["rendered_images"], real, batch["ref_rotations"],
                    batch["ref_translations"], batch["rendered_depths"],
                    batch["k"], labels, iters=cfg.model.iters,
                    sample_valid=sample_valid)

    lc = cfg.loss
    points, point_valid, symmetric, diameters = points_bank.gather(labels)
    loss_pose, seq_pose = sequence_pose_loss(
        outputs.rotations, outputs.translations, batch["gt_rotations"],
        batch["gt_translations"], points, point_valid, symmetric, diameters,
        gamma=lc.gamma, loss_weight=lc.pose_weight,
        loss_type=lc.pose_loss_type, disentangled=lc.pose_disentangled,
        disentangle_z=lc.pose_disentangle_z, sample_weight=sample_valid)
    loss_flow, seq_flow = sequence_flow_loss(
        outputs.flow_from_pred, gt_flow, batch["rendered_masks"],
        gamma=lc.gamma, loss_weight=lc.flow_weight, max_flow=cfg.model.max_flow,
        sample_weight=sample_valid)
    loss_mask, seq_mask = sequence_mask_loss(
        outputs.masks[..., 0], gt_occ, gamma=lc.gamma,
        loss_weight=lc.mask_weight, sample_weight=sample_valid)

    loss = loss_pose + loss_flow + loss_mask
    metrics = {"loss": loss, "loss_pose": loss_pose, "loss_flow": loss_flow,
               "loss_mask": loss_mask, "seq_pose_loss": seq_pose,
               "seq_flow_loss": seq_flow, "seq_mask_loss": seq_mask}
    return loss, metrics, outputs


def raft_loss(model: RAFTRefiner, batch: dict, points_bank: PointsBank,
              cfg: Config, train: bool = True):
    """RAFT training loss: (loss, metrics, (flows, occlusions)) — the
    sequence flow L1 and the occlusion-mask L1 against the targets of
    :func:`_loss_targets` (``loss_pose`` is 0). Without the occlusion head
    the occlusions are zeros and their loss is still taken, as in the JAX
    package. ``points_bank`` is unused (the signature is
    :func:`scflow_loss`'s); ``batch`` and ``train`` as there."""
    real, gt_flow, gt_occ = _loss_targets(batch, cfg)
    sample_valid = batch.get("sample_valid")
    model.train(train)
    flows, masks = model(batch["rendered_images"], real,
                         sample_valid=sample_valid)
    lc = cfg.loss
    loss_flow, seq_flow = sequence_flow_loss(
        flows, gt_flow, batch["rendered_masks"], gamma=lc.gamma,
        loss_weight=lc.flow_weight, max_flow=cfg.model.max_flow,
        sample_weight=sample_valid)
    loss_mask, seq_mask = sequence_mask_loss(
        masks[..., 0], gt_occ, gamma=lc.gamma, loss_weight=lc.mask_weight,
        sample_weight=sample_valid)
    loss = loss_flow + loss_mask
    metrics = {"loss_flow": loss_flow, "seq_flow_loss": seq_flow,
               "loss_pose": torch.zeros((), device=loss.device),
               "loss_mask": loss_mask, "seq_mask_loss": seq_mask,
               "loss": loss}
    return loss, metrics, (flows, masks)


def _train_cycle(model, renderer, points_bank, cfg, optimizer, batch, norm):
    """Render at the batch's reference pose, take the loss, its gradient
    and one clipped AdamW update: (metrics incl. grad_norm, outputs).
    ``norm``: the step's :func:`normalization` constants."""
    with torch.no_grad(), span("render"):
        rendered, depth, mask = render_at_pose(
            renderer, batch["ref_rotations"], batch["ref_translations"],
            batch["k"], batch["labels"].long(), *norm)
    with span("inputs"):
        real = device_normalize_images(batch["real_images"], norm)
    full = dict(batch, rendered_images=rendered, rendered_depths=depth,
                rendered_masks=mask, real_images=real)
    loss_fn = raft_loss if isinstance(model, RAFTRefiner) else scflow_loss
    loss, metrics, outputs = loss_fn(model, full, points_bank, cfg,
                                     train=True)
    optimizer.zero_grad(set_to_none=True)
    with span("backward"):
        loss.backward()
    with span("optimizer"):
        grads = [p.grad for g in optimizer.param_groups for p in g["params"]
                 if p.grad is not None]
        # data-parallel: sum the processes' gradients before the clip, so
        # each clips by the global norm and takes the same update
        all_reduce_grads_(grads)
        metrics = reduce_metrics({k: v.detach() for k, v in metrics.items()})
        metrics["grad_norm"] = clip_by_global_norm_(grads,
                                                    cfg.optim.grad_clip_norm)
        lr = onecycle_lr(_updates_done(optimizer), cfg.optim)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
    return metrics, outputs


def _train_setup(model, renderer, points_bank, cfg, device):
    dev = resolve_device(device)
    model.to(dev).train()
    renderer = dataclasses.replace(renderer,
                                   mesh_bank=renderer.mesh_bank.to(dev))
    return dev, renderer, points_bank.to(dev), normalization(cfg, dev)


def make_train_step(model: SCFlowRefiner | RAFTRefiner, renderer: Renderer,
                    points_bank: PointsBank, cfg: Config,
                    optimizer: torch.optim.Optimizer,
                    device: str | torch.device = "cuda"):
    """Train step on ``device``: render at the reference pose (no grad),
    ``scflow_loss`` (RAFT: ``raft_loss``) in train mode, backward, clip,
    one AdamW update at the schedule's learning rate. The model (moved to
    the device in place) and the optimizer (built by :func:`make_optimizer` over its parameters)
    change in place; the step returns its metrics, ``grad_norm`` (before the
    clip) among them. Raises if CUDA is asked for and absent."""
    dev, renderer, points_bank, norm = _train_setup(model, renderer,
                                                    points_bank, cfg, device)

    def train_step(batch: dict) -> dict:
        with span("step"):
            with span("inputs"):
                batch = {k: _to_device(v, dev) for k, v in batch.items()}
            metrics, _ = _train_cycle(model, renderer, points_bank, cfg,
                                      optimizer, batch, norm)
            return metrics

    return train_step


def make_multi_cycle_train_step(model: SCFlowRefiner, renderer: Renderer,
                                points_bank: PointsBank, cfg: Config,
                                optimizer: torch.optim.Optimizer,
                                cycles: int = 2,
                                device: str | torch.device = "cuda"):
    """Multi-cycle training: ``cycles`` train cycles per call, each one
    update; the next cycle renders at the previous cycle's detached
    last-iteration pose. Metrics: ``cycle{i}_loss`` and the last cycle's.
    SCFlow only: a RAFT model has no in-loop pose (ValueError)."""
    if isinstance(model, RAFTRefiner):
        raise ValueError("multi-cycle training needs in-loop poses "
                         "(SCFlow family only)")
    dev, renderer, points_bank, norm = _train_setup(model, renderer,
                                                    points_bank, cfg, device)

    def train_step(batch: dict) -> dict:
        with span("step"):
            with span("inputs"):
                batch = {k: _to_device(v, dev) for k, v in batch.items()}
            merged = {}
            for i in range(cycles):
                metrics, outputs = _train_cycle(model, renderer, points_bank,
                                                cfg, optimizer, batch, norm)
                merged[f"cycle{i}_loss"] = metrics["loss"]
                batch = dict(
                    batch, ref_rotations=outputs.rotations[-1].detach(),
                    ref_translations=outputs.translations[-1].detach())
            merged.update(metrics)
            return merged

    return train_step
