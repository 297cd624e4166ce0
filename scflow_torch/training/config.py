"""Configuration dataclasses for the port's inference path (the fields of
``scflow_tpu/training/config.py`` that the eval step reads, with the same
names and defaults). The model is the SCFlow family in float32 with a
shared feature encoder, Basic net, ortho6d rotations and exp depth
transform; fields with other values come with the slices that run them."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ModelConfig:
    num_class: int = 21
    feat_channels: int = 256
    h_channels: int = 128
    cxt_channels: int = 128
    num_levels: int = 4
    radius: int = 4
    iters: int = 8
    test_iters: int = 8
    # carry the pose-induced flow at feature resolution during eval
    lowres_eval: bool = True


@dataclasses.dataclass
class RenderConfig:
    image_size: tuple = (256, 256)


@dataclasses.dataclass
class DataConfig:
    normalize_mean: tuple = (0.0, 0.0, 0.0)
    normalize_std: tuple = (255.0, 255.0, 255.0)


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
