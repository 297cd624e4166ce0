"""Configuration dataclasses for the port's inference and training paths
(the fields of ``scflow_tpu/training/config.py`` that these paths read,
with the same names and defaults), and the YCB-V constants. The model is
the SCFlow family or the RAFT flow(+occlusion) family with a shared feature
encoder and Basic net; SCFlow with ortho6d rotations and exp depth
transform, in float32 or bfloat16. Fields with other values come with the
slices that run them.

One deliberate difference: ``DataConfig`` has no ``use_native`` /
``native_crop``. The port's eval crop has the semantics of the JAX
package's C++ crop (``data.pipeline.crop_resize_pad_batch``), its train
crop those of its cv2 crop (``data.pipeline.crop_resize_pad``)."""
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
    # multi-cycle training / multi-pass testing: re-render at the refined
    # pose between cycles/passes
    train_cycles: int = 1
    test_passes: int = 1
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
    add_limit: float = 1.0            # × mesh diameter


@dataclasses.dataclass
class RenderConfig:
    image_size: tuple = (256, 256)


@dataclasses.dataclass
class DataConfig:
    batch_size: int = 16
    image_scale: int = 256
    # train crops: the reference-pose bbox expanded by U(crop_size_range)
    crop_size_range: tuple = (1.0, 1.25)
    # eval crops: the reference-pose bbox expanded by this factor
    test_crop_size: float = 1.1
    normalize_mean: tuple = (0.0, 0.0, 0.0)
    normalize_std: tuple = (255.0, 255.0, 255.0)
    min_visib_fract: float = 0.2
    # train-time photometric augmentation of the real-image crop: HSV ->
    # noise -> smooth (reference configs/refine_models/scflow_ycbv_pbr.py:69-71)
    color_aug: bool = True
    # multi-object scene batching: every visible object of `scene_images`
    # images in `slots_per_image` padded slots masked by sample_valid; the
    # batch is scene_images * slots_per_image
    scene_mode: bool = False
    scene_images: int = 4
    slots_per_image: int = 4
    # background replacement and occlusion of the train crop (reference
    # RandomBackground / RandomOcclusion / RandomOcclusionV2,
    # datasets/pipelines/color_transform.py:176-403); occlusion_v2 pastes
    # other objects' crops from a reservoir of recent samples
    background_dir: str | None = None
    background_p: float = 0.3
    occlusion_p: float = 0.0
    occlusion_v2_p: float = 0.0


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    jitter: JitterConfig = dataclasses.field(default_factory=JitterConfig)
    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    seed: int = 0
    checkpoint_interval: int = 10_000
    log_interval: int = 50
    work_dir: str = "work_dirs/scflow"
    # mirror scalar logs and image panels into work_dir/tb as TensorBoard
    # event files (JSONL and PNGs stay the primary record)
    tensorboard: bool = True


# YCB-V constants (reference configs/refine_models/scflow_ycbv_pbr.py:18-39)
YCBV_SYMMETRIC_CLASSES = (12, 15, 18, 19, 20)  # 0-based: cls 13,16,19,20,21
YCBV_MESH_DIAMETERS = (
    172.16, 269.58, 198.38, 120.66, 199.79, 90.17, 142.58, 114.39, 129.73,
    198.40, 263.60, 260.76, 162.27, 126.86, 230.44, 237.30, 204.11, 121.46,
    183.08, 231.39, 102.92)
YCBV_CLASS_NAMES = (
    "master_chef_can", "cracker_box", "sugar_box", "tomato_soup_can",
    "mustard_bottle", "tuna_fish_can", "pudding_box", "gelatin_box",
    "potted_meat_can", "banana", "pitcher_base", "bleach_cleanser", "bowl",
    "mug", "power_drill", "wood_block", "scissors", "large_marker",
    "large_clamp", "extra_large_clamp", "foam_brick")
