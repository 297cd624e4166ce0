"""Data for the training path: synthetic batches."""
from .synthetic import (default_intrinsics, jitter_pose,  # noqa: F401
                        synthetic_batch)
