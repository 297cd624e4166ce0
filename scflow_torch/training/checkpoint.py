"""Checkpoints of the port's training state, and reference ``.pth`` loading
(port of ``scflow_tpu/training/checkpoint.py``).

A checkpoint is the directory ``ckpt_dir/step_%08d`` holding one torch file,
``state.pt``: the model's ``state_dict`` (BN running statistics included),
the AdamW ``state_dict`` (its per-parameter ``step`` is the count of
updates the OneCycle schedule reads) and the step. It is written to a
temporary directory and renamed into place, so a crash leaves no partial
checkpoint; the newest ``max_to_keep`` are kept.

The JAX package's orbax checkpoints are not read here: that needs JAX.
Weights cross between the packages through ``weights.load_jax_variables``
/ ``to_jax_variables``, or through a reference torch ``.pth``, which both
load.
"""
from __future__ import annotations

import os
import shutil

import torch
from torch import nn

STATE_FILE = "state.pt"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def save_checkpoint(ckpt_dir: str, model: nn.Module,
                    optimizer: torch.optim.Optimizer, step: int,
                    max_to_keep: int = 5) -> str:
    """Write ``ckpt_dir/step_<step>`` (replacing one of that step) and
    prune all but the newest ``max_to_keep``; returns its path."""
    path = _step_dir(ckpt_dir, step)
    tmp = f"{path}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(), "step": step},
               os.path.join(tmp, STATE_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    _prune_checkpoints(ckpt_dir, max_to_keep)
    return path


def restore_checkpoint(ckpt_dir: str, model: nn.Module,
                       optimizer: torch.optim.Optimizer | None = None,
                       step: int | None = None) -> int:
    """Load checkpoint ``step`` (default: the newest) into ``model`` and,
    when given, ``optimizer``, in place on their devices; returns its
    step."""
    if step is None:
        steps = list_checkpoint_steps(ckpt_dir)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        step = steps[-1]
    state = torch.load(os.path.join(_step_dir(ckpt_dir, step), STATE_FILE),
                       map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"])
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])


def list_checkpoint_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_")[1]))
            except (IndexError, ValueError):
                pass
    return sorted(steps)


def _prune_checkpoints(ckpt_dir: str, max_to_keep: int):
    steps = list_checkpoint_steps(ckpt_dir)
    for step in steps[:-max_to_keep]:
        shutil.rmtree(_step_dir(ckpt_dir, step), ignore_errors=True)


def normalize_torch_state(torch_state: dict) -> dict:
    """Unwrap mmengine checkpoint dicts and strip DDP prefixes."""
    if "state_dict" in torch_state and isinstance(
            torch_state["state_dict"], dict):
        torch_state = torch_state["state_dict"]
    out = {}
    for k, v in torch_state.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = v
    return out


def load_torch_checkpoint(path: str, model: nn.Module) -> dict:
    """Load a reference torch ``.pth`` (a raw ``state_dict`` or an mmengine
    checkpoint, ``module.`` prefixes allowed) into ``model`` in place: the
    port's tensors carry the reference names, so no conversion is needed.

    The file is unpickled in full, as an mmengine checkpoint's metadata
    needs: load only files from a source you trust.

    A model with ``separate_encoder`` reads the reference's
    ``seperate_encoder=True`` layout: its ``real_encoder`` takes the
    checkpoint's ``real_encoder.*`` tensors, or a copy of the render
    encoder's where the checkpoint has none (a shared-encoder checkpoint),
    as the JAX converter's ``separate_encoder=True`` does.

    Returns the report ``{"covered", "missing", "unused"}`` of tensor
    names: ``missing`` tensors of the model keep their values (a reference
    instance norm without affine parameters leaves the port's at 1 and 0,
    the same function); an ``unused`` checkpoint tensor or a shape that
    disagrees raises ValueError before anything is loaded.
    """
    ckpt = normalize_torch_state(
        torch.load(path, map_location="cpu", weights_only=False))
    if getattr(model, "separate_encoder", False) and not any(
            k.startswith("real_encoder.") for k in ckpt):
        ckpt.update({"real_encoder" + k[len("render_encoder"):]: v
                     for k, v in list(ckpt.items())
                     if k.startswith("render_encoder.")})
    own = model.state_dict()
    unused = sorted(k for k in ckpt if k not in own)
    if unused:
        raise ValueError(f"checkpoint tensors with no port slot: {unused}")
    for k, v in ckpt.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} != port "
                             f"{tuple(own[k].shape)}")
    model.load_state_dict(ckpt, strict=False)
    return {"covered": sorted(ckpt),
            "missing": sorted(k for k in own if k not in ckpt),
            "unused": unused}
