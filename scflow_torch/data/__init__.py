"""Data: synthetic batches for training; the BOP eval readers, crops and
batch builder (``bop``, ``pipeline``, ``loader``) and the PNG decoder
(``imageio``) are in their own modules."""
from .synthetic import (default_intrinsics, jitter_pose,  # noqa: F401
                        synthetic_batch)
