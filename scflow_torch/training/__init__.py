"""Configuration, the points bank, the train, eval and panel steps; the
Trainer, checkpoints, logging and the on-device eval are in their own
modules (``trainer``, ``checkpoint``, ``logging``, ``evaluate``)."""
from .config import (YCBV_CLASS_NAMES, YCBV_MESH_DIAMETERS,  # noqa: F401
                     YCBV_SYMMETRIC_CLASSES, Config, DataConfig, JitterConfig,
                     LossConfig, ModelConfig, OptimConfig, RenderConfig)
from .points_bank import PointsBank, build_points_bank  # noqa: F401
from .steps import (build_model, clip_by_global_norm_,  # noqa: F401
                    device_normalize_images, make_eval_step,
                    make_multi_cycle_train_step, make_multi_pass_eval_step,
                    make_optimizer, make_panel_step, make_train_step,
                    normalization, onecycle_lr, raft_loss, render_at_pose,
                    scflow_loss)
