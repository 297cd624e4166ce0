"""Configuration and the inference steps."""
from .config import Config, DataConfig, ModelConfig, RenderConfig  # noqa: F401
from .steps import (build_model, device_normalize_images,  # noqa: F401
                    make_eval_step, make_multi_pass_eval_step, render_at_pose)
