"""Host-side utilities: flow visualisation, the TensorBoard event writer
with its PNG encoder, profiling helpers, and flow-based warps."""
from .warp import backward_warp, forward_warp_splat  # noqa: F401
