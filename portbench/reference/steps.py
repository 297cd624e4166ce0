"""The plain reference of the steps the benchmark times, built from a
configuration file's values alone: normalise, render at the reference
pose, the refiner network, the last iteration's pose (RAFT: RANSAC-EPnP on
the last flow, the reference pose where it fails); and the train step:
render, targets, the loss of the family, backward, optax's global-norm
clip, AdamW at the linear OneCycle learning rate."""
from __future__ import annotations


import torch

from .geometry.flow import filter_flow_by_mask, flow_from_pose_and_depth
from .losses import sequence_flow_loss, sequence_mask_loss, sequence_pose_loss
from .models.flow_pose import solve_pose_from_flow
from .models.refiner import RAFTRefiner, SCFlowRefiner
from .rendering.renderer import render

RAFT_FAMILIES = ("raft_flow", "raft_flow_mask")


def build_model(model_cfg: dict, image_size, device) -> torch.nn.Module:
    """The refiner of ``model_cfg['family']`` with empty float32 weights on
    ``device`` in eval mode (the caller loads them)."""
    m = model_cfg
    common = dict(separate_encoder=m["separate_encoder"],
                  h_channels=m["h_channels"], cxt_channels=m["cxt_channels"],
                  feat_channels=m["feat_channels"], net_type=m["net_type"],
                  num_levels=m["num_levels"], radius=m["radius"],
                  iters=m["iters"])
    with torch.device("meta"):
        if m["family"] in RAFT_FAMILIES:
            model = RAFTRefiner(predict_mask=m["family"] == "raft_flow_mask",
                                **common)
        else:
            model = SCFlowRefiner(
                num_class=m["num_class"], rotation_mode=m["rotation_mode"],
                depth_transform=m["depth_transform"],
                detach_depth_for_xy=m["detach_depth_for_xy"],
                mask_flow=m["mask_flow"], mask_corr=m["mask_corr"],
                image_size=tuple(image_size), **common)
    return model.to_empty(device=device).eval()


def _normalised(images: torch.Tensor, cfg: dict) -> torch.Tensor:
    mean = torch.tensor(cfg["normalize"]["mean"], device=images.device)
    std = torch.tensor(cfg["normalize"]["std"], device=images.device)
    if images.dtype == torch.uint8:
        return (images.float() - mean) / std
    return (images - mean / 255.0) / (std / 255.0)


def render_normalised(mesh, batch, cfg: dict):
    """(normalised render (N, H, W, 3), depth, mask float) at the batch's
    reference pose."""
    out = render(mesh, batch["ref_rotations"], batch["ref_translations"],
                 batch["k"], batch["labels"].long(), cfg["image_size"])
    return (_normalised(out["images"], cfg), out["depth"],
            out["mask"].float())


@torch.no_grad()
def eval_step(model, mesh, batch: dict, cfg: dict, stages: dict | None = None):
    """The eval step's outputs (rotations, translations, masks, flow,
    depth); ``stages`` (a dict) receives the render and the encoders'
    features on the way."""
    m = cfg["model"]
    model.eval()
    real = _normalised(batch["real_images"], cfg)
    rendered, depth, mask = render_normalised(mesh, batch, cfg)
    if stages is not None:
        stages.update(render_images=rendered, render_depth=depth,
                      render_mask=mask)
        hook = model.render_encoder.register_forward_hook(
            lambda mod, args, out: stages.setdefault("features", []).append(
                out))
    try:
        if isinstance(model, RAFTRefiner):
            flows, masks = model(rendered, real, iters=m["test_iters"])
            solved = pnp_leg(flows[-1], masks[-1], depth, batch, cfg)
            return {"rotations": solved["rotations"],
                    "translations": solved["translations"],
                    "masks": masks[-1], "flow": flows[-1], "depth": depth,
                    "pnp_valid": solved["valid"]}
        out = model(rendered, real, batch["ref_rotations"],
                    batch["ref_translations"], depth, batch["k"],
                    batch["labels"].long(), iters=m["test_iters"],
                    lowres=m["lowres_eval"])
    finally:
        if stages is not None:
            hook.remove()
    return {"rotations": out.rotations[-1],
            "translations": out.translations[-1], "masks": out.masks[-1],
            "flow": out.flow_from_pred[-1], "depth": depth}


def pnp_leg(flow, masks, depth, batch: dict, cfg: dict) -> dict:
    """RANSAC-EPnP on a last flow (N, H, W, 2) and occlusion (N, H, W, 1)
    with the depth rendered at the batch's reference pose, on noise from
    a generator seeded 0 on the flow's device (the eval step's fixed
    draws): rotations, translations and ``valid``."""
    p = cfg["pnp"]
    return solve_pose_from_flow(
        torch.Generator(device=flow.device).manual_seed(0), flow,
        masks[..., 0], depth, batch["ref_rotations"],
        batch["ref_translations"], batch["k"],
        occlusion_threshold=p["occlusion_threshold"],
        max_points=p["max_points"], num_hypotheses=p["num_hypotheses"],
        inlier_threshold=p["inlier_threshold_px"],
        min_valid_points=p["min_valid_points"])


def loss(model, mesh, points: dict, batch: dict, cfg: dict,
         drop_half: bool = False) -> torch.Tensor:
    """The family's training loss of a batch in train mode, rendered at the
    reference pose without gradient. ``drop_half`` leaves out the second
    half of the batch (a planted fault: the mean is then taken over the
    rest)."""
    if drop_half:
        half = batch["labels"].shape[0] // 2
        batch = {k: v[:half] for k, v in batch.items()}
    with torch.no_grad():
        rendered, depth, rmask = render_normalised(mesh, batch, cfg)
    return loss_of_render(model, rendered, depth, rmask, points, batch, cfg)


def loss_of_render(model, rendered, depth, rmask, points: dict, batch: dict,
                   cfg: dict) -> torch.Tensor:
    """The loss given the render: targets from the GT pose and the
    rendered depth, the network in train mode, the family's terms."""
    m, lc = cfg["model"], cfg["loss"]
    real = _normalised(batch["real_images"], cfg)
    gt_flow = flow_from_pose_and_depth(
        batch["ref_rotations"], batch["ref_translations"],
        batch["gt_rotations"], batch["gt_translations"], depth, batch["k"],
        invalid_num=m["max_flow"])
    if m["filter_invalid_flow"]:
        gt_flow = filter_flow_by_mask(gt_flow, batch["gt_masks"].float(),
                                      invalid_num=m["max_flow"])
    gt_occ = (gt_flow.sum(-1) < m["max_flow"]).float()
    model.train()
    if isinstance(model, RAFTRefiner):
        flows, masks = model(rendered, real)
        total = 0.0
    else:
        labels = batch["labels"].long()
        out = model(rendered, real, batch["ref_rotations"],
                    batch["ref_translations"], depth, batch["k"], labels,
                    iters=m["iters"])
        flows, masks = out.flow_from_pred, out.masks
        total, _ = sequence_pose_loss(
            out.rotations, out.translations, batch["gt_rotations"],
            batch["gt_translations"], points["points"][labels],
            points["valid"][labels], points["symmetric"][labels],
            points["diameters"][labels], gamma=lc["gamma"],
            loss_weight=lc["pose_weight"], loss_type=lc["pose_loss_type"],
            disentangled=lc["pose_disentangled"],
            disentangle_z=lc["pose_disentangle_z"])
    loss_flow, _ = sequence_flow_loss(flows, gt_flow, rmask,
                                      gamma=lc["gamma"],
                                      loss_weight=lc["flow_weight"],
                                      max_flow=m["max_flow"])
    loss_mask, _ = sequence_mask_loss(masks[..., 0], gt_occ,
                                      gamma=lc["gamma"],
                                      loss_weight=lc["mask_weight"])
    return total + loss_flow + loss_mask


def onecycle_lr(step: int, o: dict) -> float:
    """optax's linear OneCycle schedule at update ``step`` (from 0)."""
    total = max(o["total_steps"], 100)
    bounds = (0, int(o["pct_start"] * total),
              int((1.0 - o["pct_start"]) * total), total)
    values = [o["lr"] / o["div_factor"]]
    for scale in (o["div_factor"], 1.0 / o["div_factor"],
                  1.0 / o["final_div_factor"]):
        values.append(values[-1] * scale)
    for b0, b1, v0, v1 in zip(bounds, bounds[1:], values, values[1:]):
        if b0 <= step < b1:
            return (v1 - v0) * ((step - b0) / (b1 - b0)) + v0
    return values[-1]


def train_steps(model, mesh, points: dict, batches: list, cfg: dict,
                drop_half: bool = False) -> dict:
    """Train ``model`` in place through ``batches``, one clipped AdamW
    update each: {losses [float], first_grads {name: tensor} (as the
    optimizer got them), params {name: tensor} after the last update}."""
    o = cfg["optim"]
    named = [(n, p) for n, p in model.named_parameters()]
    opt = torch.optim.AdamW([p for _, p in named], lr=onecycle_lr(0, o),
                            betas=tuple(o["betas"]), eps=o["eps"],
                            weight_decay=o["weight_decay"], foreach=False)
    losses, first = [], None
    for i, batch in enumerate(batches):
        opt.zero_grad(set_to_none=True)
        value = loss(model, mesh, points, batch, cfg, drop_half)
        value.backward()
        grads = [p.grad for _, p in named if p.grad is not None]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        scale = (o["grad_clip_norm"] / norm).clamp(max=1.0).float()
        for g in grads:
            g.mul_(scale)
        if first is None:
            first = {n: p.grad.detach().clone() for n, p in named
                     if p.grad is not None}
        for group in opt.param_groups:
            group["lr"] = onecycle_lr(i, o)
        opt.step()
        losses.append(float(value.detach()))
    return {"losses": losses, "first_grads": first,
            "params": {n: p.detach().clone() for n, p in named}}


def angle_deg(r_a: torch.Tensor, r_b: torch.Tensor) -> torch.Tensor:
    """Angles (N,) in degrees between rotations (N, 3, 3), from the chord
    ‖R_a − R_b‖_F = 2√2·sin(θ/2), in float64 (0 for equal matrices)."""
    chord = torch.linalg.matrix_norm(r_a.double() - r_b.double())
    return torch.rad2deg(2.0 * torch.arcsin((chord / 8 ** 0.5).clamp(max=1.0)))



