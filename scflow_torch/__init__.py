"""PyTorch/CUDA port of scflow_tpu: SCFlow pose refinement on NVIDIA Hopper.

Mirrors the module tree of ``scflow_tpu`` (geometry, rendering, ops,
models, training). Plain tensor code is PyTorch; the two kernels that
``scflow_tpu`` wrote in Pallas (the tile rasterizer and the fused instance
norm) are hand-written CUDA C++ under ``ops/csrc``, built for ``sm_90a``
at first use. Nothing here imports JAX.

Entry points default to ``device="cuda"`` and raise when no GPU is
present; pass ``device="cpu"`` to run the plain PyTorch versions.
"""
from .device import resolve_device  # noqa: F401
