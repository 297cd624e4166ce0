"""Configuration dataclasses for the port's inference and training paths
(the fields of ``scflow_tpu/training/config.py`` that these paths read,
with the same names and defaults). The model is the SCFlow family or the
RAFT flow(+occlusion) family with a shared feature encoder and Basic net;
SCFlow with ortho6d rotations and exp depth transform, in float32 or
bfloat16. Fields with other values come with the slices that run them."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ModelConfig:
    family: str = "scflow"            # 'scflow' | 'raft_flow' | 'raft_flow_mask'
    num_class: int = 21
    feat_channels: int = 256
    h_channels: int = 128
    cxt_channels: int = 128
    num_levels: int = 4
    radius: int = 4
    iters: int = 8
    test_iters: int = 8
    max_flow: float = 400.0
    filter_invalid_flow: bool = True
    # compute dtype of the SCFlow conv/matmul stack: 'float32' | 'bfloat16'
    # (parameters and all geometry/pose math stay float32; RAFT runs f32)
    dtype: str = "float32"
    # carry the pose-induced flow at feature resolution during eval
    lowres_eval: bool = True


@dataclasses.dataclass
class LossConfig:
    gamma: float = 0.8
    pose_weight: float = 10.0
    flow_weight: float = 0.1
    mask_weight: float = 10.0
    pose_loss_type: str = "l1"
    pose_disentangled: bool = True
    pose_disentangle_z: bool = True
    num_loss_points: int = 512        # mesh points sampled per class


@dataclasses.dataclass
class OptimConfig:
    lr: float = 4e-4
    total_steps: int = 100_000
    pct_start: float = 0.05
    weight_decay: float = 1e-4
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    grad_clip_norm: float = 10.0
    div_factor: float = 25.0          # torch OneCycleLR defaults
    final_div_factor: float = 1e4


@dataclasses.dataclass(frozen=True)
class JitterConfig:
    """Gaussian SE(3) jitter of the GT pose into the reference pose."""
    angle_std_deg: float = 15.0
    xy_std_mm: float = 15.0
    z_std_mm: float = 50.0
    angle_limit_deg: float = 45.0
    translation_limit_mm: float = 200.0


@dataclasses.dataclass
class RenderConfig:
    image_size: tuple = (256, 256)


@dataclasses.dataclass
class DataConfig:
    batch_size: int = 16
    normalize_mean: tuple = (0.0, 0.0, 0.0)
    normalize_std: tuple = (255.0, 255.0, 255.0)


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    jitter: JitterConfig = dataclasses.field(default_factory=JitterConfig)
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
