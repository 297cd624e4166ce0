"""Data: synthetic batches for training; the BOP readers (``bop``,
``tracking``), crops (``pipeline``), color augmentations (``color_aug``)
and their cv2 forms (``cvops``), the batch builders and prefetcher
(``loader``) and the PNG decoder (``imageio``) are in their own modules;
``InstanceMasks`` is the host-side mask toolkit."""
from .masks import InstanceMasks  # noqa: F401
from .synthetic import (default_intrinsics, jitter_pose,  # noqa: F401
                        synthetic_batch)
