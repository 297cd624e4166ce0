"""The system under test: the port's eval or train step, built through
its own entry points from the configuration file and handed the
benchmark's meshes, weights and loss points. This is the one module of
the benchmark that imports the port."""
from __future__ import annotations

import torch

from scflow_torch.rendering.mesh import MeshBank
from scflow_torch.rendering.renderer import Renderer
from scflow_torch.training import (Config, ModelConfig, build_model,
                                   make_eval_step, make_optimizer,
                                   make_train_step)
from scflow_torch.training.config import (DataConfig, LossConfig,
                                          OptimConfig, RenderConfig)
from scflow_torch.training.points_bank import PointsBank


def port_config(cfg: dict) -> Config:
    """The port's ``Config`` holding the configuration file's values."""
    optim = dict(cfg["optim"], betas=tuple(cfg["optim"]["betas"]))
    return Config(model=ModelConfig(**cfg["model"]),
                  loss=LossConfig(**cfg["loss"]),
                  optim=OptimConfig(**optim),
                  render=RenderConfig(image_size=tuple(cfg["image_size"])),
                  data=DataConfig(
                      normalize_mean=tuple(cfg["normalize"]["mean"]),
                      normalize_std=tuple(cfg["normalize"]["std"])))


class Program:
    """The port's step for one cell: ``step(batch)`` is the timed call
    (eval: the outputs dict; train: the metrics dict), ``model`` and
    ``optimizer`` its state."""

    def __init__(self, cfg: dict, traffic: dict, meshes: dict, weights: dict,
                 points: dict, device):
        self.config = port_config(cfg)
        c = meshes["verts"].shape[0]
        bank = MeshBank(
            verts=meshes["verts"], faces=meshes["faces"],
            face_valid=torch.ones(meshes["faces"].shape[:2],
                                  dtype=torch.bool, device=device),
            vert_normals=meshes["normals"], vert_colors=meshes["colors"],
            diameters=torch.full((c,), meshes["diameter"], device=device))
        renderer = Renderer(bank, image_size=tuple(cfg["image_size"]))
        self.model = build_model(self.config, device=device)
        self.model.load_state_dict(weights)
        self.optimizer = None
        if traffic["step"] == "train":
            self.optimizer = make_optimizer(self.config,
                                            self.model.parameters())
            self.step = make_train_step(
                self.model, renderer,
                PointsBank(points=points["points"], valid=points["valid"],
                           diameters=points["diameters"],
                           symmetric=points["symmetric"]),
                self.config, self.optimizer, device=device)
        else:
            self.step = make_eval_step(self.model, renderer, self.config,
                                       device=device)

    def encoder(self) -> torch.nn.Module:
        """The module whose outputs are the render and real features."""
        return self.model.render_encoder


def launch_counts() -> tuple:
    """The port's own counters of K1 calls and K2 launches by direction and
    (form, dtype), as its wrappers keep them."""
    from scflow_torch.ops import rasterize_fast
    from scflow_torch.ops.fused_norm import instance_norm_bwd, instance_norm_fwd

    return (rasterize_fast.rasterize_tiles.launches,
            {"fwd": dict(instance_norm_fwd.form_launches),
             "bwd": dict(instance_norm_bwd.form_launches)})


def port_root() -> str:
    """The port package's directory (for attributing source lines)."""
    import os

    import scflow_torch

    return os.path.dirname(os.path.abspath(scflow_torch.__file__))
