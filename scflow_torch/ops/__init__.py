"""Hand-written CUDA kernels (``csrc/``) and the torch code around them."""
