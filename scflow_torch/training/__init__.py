"""Configuration, the points bank, and the train and eval steps."""
from .config import (Config, DataConfig, JitterConfig,  # noqa: F401
                     LossConfig, ModelConfig, OptimConfig, RenderConfig)
from .points_bank import PointsBank, build_points_bank  # noqa: F401
from .steps import (build_model, clip_by_global_norm_,  # noqa: F401
                    device_normalize_images, make_eval_step,
                    make_multi_cycle_train_step, make_multi_pass_eval_step,
                    make_optimizer, make_train_step, onecycle_lr,
                    raft_loss, render_at_pose, scflow_loss)
