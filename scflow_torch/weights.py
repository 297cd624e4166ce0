"""Weight bridge: the JAX package's flax variables into the port and back.

``variables`` is ``{"params": …, "batch_stats": …}`` as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, model.init(...))``). The port's
parameters carry the reference torch names, so each module maps to one
flax path by the rules below — the inverse of the JAX package's torch
checkpoint converter. Conv kernels go HWIO → OIHW, dense kernels are
transposed, the pose head's first FC input goes from the flax HWC flatten
to the torch CHW flatten, and BN ``mean``/``var`` become
``running_mean``/``running_var``. In a ``RAFTRefiner`` ``decoder.mask_pred``
is the convex-upsample weight head (flax ``up_mask_head``, Basic net only)
and ``decoder.occlusion_pred`` the occlusion head (``occ_head``); it has
no pose head. A ``separate_encoder`` model's ``real_encoder`` is the flax
``real_encoder``; the widths of every ``net_type`` and the 4-row
quaternion pose head map as they are.
"""
from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from .models.layers import FusedInstanceNorm
from .models.refiner import RAFTRefiner

_ENC = r"(render_encoder|real_encoder|context)"
_IT = "decoder/iteration"
_RULES = [(re.compile(p), r) for p, r in (
    (rf"{_ENC}\.conv1", r"\1/stem/conv"),
    (rf"{_ENC}\.(?:in|bn)1", r"\1/stem/norm"),
    (rf"{_ENC}\.res_layer(\d)\.(\d)\.conv(\d)", r"\1/layer\2_block\3/conv\4/conv"),
    (rf"{_ENC}\.res_layer(\d)\.(\d)\.(?:in|bn)(\d)",
     r"\1/layer\2_block\3/conv\4/norm"),
    (rf"{_ENC}\.res_layer(\d)\.(\d)\.downsample\.0",
     r"\1/layer\2_block\3/downsample/conv"),
    (rf"{_ENC}\.res_layer(\d)\.(\d)\.downsample\.1",
     r"\1/layer\2_block\3/downsample/norm"),
    (rf"{_ENC}\.conv2", r"\1/conv_out"),
    (r"decoder\.encoder\.corr_net\.(\d)\.conv", rf"{_IT}/motion/corr_conv\1/conv"),
    (r"decoder\.encoder\.flow_net\.(\d)\.conv", rf"{_IT}/motion/flow_conv\1/conv"),
    (r"decoder\.encoder\.out_net\.0\.conv", rf"{_IT}/motion/out_conv/conv"),
    (r"decoder\.gru\.conv_([zrq])\.(\d)\.conv", rf"{_IT}/gru/conv_\1_\2"),
    (r"decoder\.(flow|mask)_pred\.layers\.(\d)\.conv", rf"{_IT}/\1_head/conv\2/conv"),
    (r"decoder\.(flow|mask)_pred\.predict_layer", rf"{_IT}/\1_head/predict"),
    (r"decoder\.delta_flow_encoder\.(\d)\.conv", rf"{_IT}/dflow_embed/conv\1/conv"),
    (r"decoder\.mask_encoder\.(\d)\.conv", rf"{_IT}/mask_embed/conv\1/conv"),
    (r"decoder\.pose_pred\.conv_layers\.(\d)\.conv", rf"{_IT}/pose_head/conv\1/conv"),
    (r"decoder\.pose_pred\.conv_layers\.(\d)\.gn", rf"{_IT}/pose_head/conv\1/norm"),
    (r"decoder\.pose_pred\.fc_layers\.(\d)\.0", rf"{_IT}/pose_head/fc\1"),
    (r"decoder\.pose_pred\.(rotation|translation)_pred",
     rf"{_IT}/pose_head/\1_pred"),
)]
# RAFT heads, matched before _RULES (whose mask_pred is SCFlow's mask head)
_RAFT_RULES = [(re.compile(p), r) for p, r in (
    (r"decoder\.mask_pred\.layers\.(\d)\.conv", rf"{_IT}/up_mask_head/conv\1/conv"),
    (r"decoder\.mask_pred\.predict_layer", rf"{_IT}/up_mask_head/predict"),
    (r"decoder\.occlusion_pred\.layers\.(\d)\.conv",
     rf"{_IT}/occ_head/conv\1/conv"),
    (r"decoder\.occlusion_pred\.predict_layer", rf"{_IT}/occ_head/predict"),
)]
_FC0 = "decoder.pose_pred.fc_layers.0.0"


def jax_path(module_name: str, raft: bool = False) -> str | None:
    """Flax path ('a/b/c') of the port module named ``module_name`` in an
    SCFlow refiner, or with ``raft`` in a RAFT refiner."""
    for pattern, repl in (_RAFT_RULES if raft else []) + _RULES:
        if pattern.fullmatch(module_name):
            return pattern.sub(repl, module_name)
    return None


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def load_jax_variables(model: nn.Module, variables: dict) -> None:
    """Fill ``model`` (an ``SCFlowRefiner`` or ``RAFTRefiner``) from flax
    ``variables`` in place. Raises if a port tensor gets no value, a flax leaf goes unused,
    or a shape disagrees."""
    params = _flatten(variables.get("params", {}))
    stats = _flatten(variables.get("batch_stats", {}))
    used: set[str] = set()

    def take(tree, tag, path):
        used.add(f"{tag}/{path}")
        return tree[path]

    loaded = {}
    raft = isinstance(model, RAFTRefiner)
    for name, m in model.named_modules():
        if not isinstance(m, (nn.Conv2d, nn.Linear, nn.BatchNorm2d,
                              nn.GroupNorm, FusedInstanceNorm)):
            continue
        path = jax_path(name, raft)
        if path is None:
            raise KeyError(f"no flax path for port module {name!r}")
        vals = {}
        if isinstance(m, nn.Conv2d):
            vals["weight"] = take(params, "params", f"{path}/kernel").transpose(
                3, 2, 0, 1)
            vals["bias"] = take(params, "params", f"{path}/bias")
        elif isinstance(m, nn.Linear):
            w = take(params, "params", f"{path}/kernel").T       # (out, in)
            if name == _FC0:
                # flax flattens (H, W, C); torch flattens (C, H, W)
                c = model.decoder.pose_pred.conv_layers[-1].conv.out_channels
                s = int(round((w.shape[1] // c) ** 0.5))
                w = (w.reshape(w.shape[0], s, s, c).transpose(0, 3, 1, 2)
                     .reshape(w.shape))
            vals["weight"] = w
            vals["bias"] = take(params, "params", f"{path}/bias")
        else:
            vals["weight"] = take(params, "params", f"{path}/scale")
            vals["bias"] = take(params, "params", f"{path}/bias")
            if isinstance(m, nn.BatchNorm2d):
                vals["running_mean"] = take(stats, "batch_stats", f"{path}/mean")
                vals["running_var"] = take(stats, "batch_stats", f"{path}/var")
        for attr, v in vals.items():
            loaded[f"{name}.{attr}"] = torch.from_numpy(
                np.array(v, dtype=np.float32))

    state = model.state_dict()
    missing = [k for k in state
               if k not in loaded and not k.endswith("num_batches_tracked")]
    unused = sorted(({f"params/{p}" for p in params}
                     | {f"batch_stats/{p}" for p in stats}) - used)
    if missing or unused:
        raise KeyError(f"port tensors without a flax value: {missing}; "
                       f"flax leaves unused: {unused}")
    for k, v in loaded.items():
        if tuple(v.shape) != tuple(state[k].shape):
            raise ValueError(f"{k}: flax shape {tuple(v.shape)} != port "
                             f"shape {tuple(state[k].shape)}")
    model.load_state_dict(loaded, strict=False)


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def to_jax_variables(model: nn.Module, grad: bool = False) -> dict:
    """The inverse of :func:`load_jax_variables`: flax ``{"params": …,
    "batch_stats": …}`` as nested dicts of f32 numpy arrays, from the
    port's parameters or, with ``grad=True``, from their ``.grad`` (which
    must all be set). ``batch_stats`` are the BN running statistics."""
    params, stats = {}, {}
    raft = isinstance(model, RAFTRefiner)
    for name, m in model.named_modules():
        if not isinstance(m, (nn.Conv2d, nn.Linear, nn.BatchNorm2d,
                              nn.GroupNorm, FusedInstanceNorm)):
            continue
        path = jax_path(name, raft)
        if path is None:
            raise KeyError(f"no flax path for port module {name!r}")

        def value(t):
            if grad:
                if t.grad is None:
                    raise ValueError(f"{name}: a parameter has no gradient")
                t = t.grad
            return t.detach().float().cpu().numpy()

        w, b = value(m.weight), value(m.bias)
        if isinstance(m, nn.Conv2d):
            params[f"{path}/kernel"] = w.transpose(2, 3, 1, 0)     # HWIO
        elif isinstance(m, nn.Linear):
            if name == _FC0:
                # torch flattens (C, H, W); flax flattens (H, W, C)
                c = model.decoder.pose_pred.conv_layers[-1].conv.out_channels
                s = int(round((w.shape[1] // c) ** 0.5))
                w = w.reshape(w.shape[0], c, s, s).transpose(0, 2, 3, 1).reshape(
                    w.shape)
            params[f"{path}/kernel"] = w.T
        else:
            params[f"{path}/scale"] = w
            if isinstance(m, nn.BatchNorm2d):
                stats[f"{path}/mean"] = m.running_mean.float().cpu().numpy()
                stats[f"{path}/var"] = m.running_var.float().cpu().numpy()
        params[f"{path}/bias"] = b
    out = {"params": _nest({k: np.ascontiguousarray(v)
                            for k, v in params.items()})}
    if stats:
        out["batch_stats"] = _nest(stats)
    return out
