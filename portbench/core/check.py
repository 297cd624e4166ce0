"""The numbers that decide ``correct``: what the timed path produced
against the plain reference on the same inputs and weights.

Eval cells: every step's poses in the window (host copies) against the
reference's poses of the same batch (RAFT: against the batch's last
step, whose pose is judged against the reference's PnP leg); the last
flow, occlusion mask and depth of two pool batches drawn from the seed;
the render and the encoders' features of one more call of the same step
on one of them.
Train cells: the first steps' losses, the first gradient as the optimizer
got it (from its state after one update) and the parameters' change
after those steps, each leaf's norm against the reference's."""
from __future__ import annotations

import math

import torch

from ..reference.steps import angle_deg


def _max(x: torch.Tensor) -> float:
    """The largest entry, NaN if any entry is not finite."""
    x = x.double()
    if not bool(torch.isfinite(x).all()):
        return math.nan
    return float(x.max()) if x.numel() else 0.0


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest absolute difference; infinite where the shapes differ."""
    if a.shape != b.shape:
        return math.inf
    return _max((a.double() - b.double()).abs())


def _worst(values) -> float:
    """The largest value, NaN if any is NaN."""
    values = list(values)
    return math.nan if any(v != v for v in values) else max(values)


def _pose_gaps(seen, r_ref, t_ref):
    """(largest angle in degrees, largest translation gap in mm) of
    (rotations, translations) pairs against one reference pose batch."""
    r_ref, t_ref = r_ref.cpu(), t_ref.cpu()
    rot, trans = [], []
    for r, t in seen:
        if r.shape != r_ref.shape or t.shape != t_ref.shape:
            return math.inf, math.inf
        rot.append(_max(angle_deg(r.cpu(), r_ref)))
        trans.append(_max(torch.linalg.vector_norm(
            t.cpu().double() - t_ref.double(), dim=-1)))
    return _worst(rot), _worst(trans)


def eval_numbers(poses: dict, kept: dict, stages: dict, ref: dict,
                 ref_stages: dict, pnp: dict | None = None) -> dict:
    """poses: pool index → [(rotations, translations)] on the host, one a
    step; kept: pool index → the last outputs of that batch; stages: the
    port's render (images, depth) and features; ref / ref_stages: the
    reference's outputs by pool index and its stages. ``pnp`` (RAFT):
    pool index → the reference's PnP leg on the port's own kept flow,
    occlusion and depth; the poses are then judged against it, stage by
    stage, since RANSAC's winner on random-weight flow turns on the last
    bits of the flow. Every other step's poses are then held to their
    batch's last step (``repeat_*``): the step's draws are fixed, so a
    sound step repeats its answer for the same batch exactly."""
    feats, feats_ref = stages["features"], ref_stages["features"]
    if pnp is None:
        gaps = [_pose_gaps(seen, ref[b]["rotations"], ref[b]["translations"])
                for b, seen in poses.items()]
        out = {"rotation_deg": _worst(g[0] for g in gaps),
               "translation_mm": _worst(g[1] for g in gaps)}
    else:
        gaps = [_pose_gaps([(o["rotations"], o["translations"])],
                           pnp[b]["rotations"], pnp[b]["translations"])
                if pnp[b] is not None else (math.inf, math.inf)
                for b, o in kept.items()]
        repeats = [_pose_gaps(seen, *seen[-1]) for seen in poses.values()]
        out = {"repeat_rotation_deg": _worst(g[0] for g in repeats),
               "repeat_translation_mm": _worst(g[1] for g in repeats),
               "pnp_rotation_deg": _worst(g[0] for g in gaps),
               "pnp_translation_mm": _worst(g[1] for g in gaps),
               "pnp_valid_mismatch": float(sum(
                   int((o["pnp_valid"].cpu() != pnp[b]["valid"].cpu()).sum())
                   if pnp[b] is not None else math.inf
                   for b, o in kept.items()))}
    return dict(out, **{
        "flow_px": _worst(_gap(o["flow"], ref[b]["flow"])
                          for b, o in kept.items()),
        "mask": _worst(_gap(o["masks"], ref[b]["masks"])
                       for b, o in kept.items()),
        "features_rel": (_worst(_gap(f, g) for f, g in zip(feats, feats_ref))
                         / _worst(_max(f.abs()) for f in feats_ref)
                         if len(feats) == len(feats_ref) else math.inf),
        "render": _worst(
            [_gap(stages["render_images"], ref_stages["render_images"]),
             _gap(stages["render_depth"], ref_stages["render_depth"])]
            + [_gap(o["depth"], ref[b]["depth"]) for b, o in kept.items()]),
    })


def _leaf_norms(tensors: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.double()))
            for n, t in tensors.items()}


def _worst_leaf(port: dict, ref: dict, names) -> float:
    """max over leaves of |‖port‖ − ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    names = list(names)
    if set(port) != set(ref):
        return math.inf
    p, r = _leaf_norms({n: port[n] for n in names}), \
        _leaf_norms({n: ref[n] for n in names})
    median = sorted(r.values())[len(r) // 2]
    worst = 0.0
    for n in names:
        if not (math.isfinite(p[n]) and math.isfinite(r[n])):
            return math.nan
        worst = max(worst, abs(p[n] - r[n]) / max(r[n], median))
    return worst


def moved_leaves(first_grads: dict, floor: float = 1e-3) -> list:
    """The leaves whose reference gradient is not nought to rounding: a
    norm of at least ``floor`` times the median leaf's."""
    norms = _leaf_norms(first_grads)
    median = sorted(norms.values())[len(norms) // 2]
    return sorted(n for n, v in norms.items() if v >= floor * median)


def train_numbers(port: dict, ref: dict, initial: dict) -> dict:
    """port / ref: {losses, first_grads, params}; initial: the weights
    both started from."""
    losses = [abs(a - b) / max(abs(b), 1e-12)
              for a, b in zip(port["losses"], ref["losses"])]
    loss = (max(losses) if all(map(math.isfinite, port["losses"]))
            and len(port["losses"]) == len(ref["losses"]) else math.nan)
    grad = _worst_leaf(port["first_grads"], ref["first_grads"],
                       ref["first_grads"])
    keep = moved_leaves(ref["first_grads"])
    change = _worst_leaf({n: port["params"][n] - initial[n] for n in keep},
                         {n: ref["params"][n] - initial[n] for n in keep},
                         keep)
    return {"loss_rel": loss, "grad_leaf": grad, "change_leaf": change}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every limited number finite and
    within its limit; a number without a limit is reported, not held."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is not None and not (value <= limit):
            ok = False
    missing = set(limits) - set(numbers)
    return ok and not missing, checks
