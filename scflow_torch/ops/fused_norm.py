"""Instance norm: a CUDA forward kernel and its plain PyTorch version.

Port of ``scflow_tpu/ops/fused_norm.py``. Per (sample, channel) of an
NCHW activation: f32 mean and biased variance over H·W, then
``(x − μ)·rsqrt(var + eps)·scale + bias`` cast back to the type of x. On
CUDA tensors :func:`instance_norm` launches ``csrc/instance_norm.cu``
(one read and one write of x); on CPU tensors it runs
:func:`instance_norm_reference`, the formula of the JAX package's
``_reference_in``. This slice is inference only: the backward kernel comes
with training.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# one plane lives in shared memory as f32 (227 KB per block on Hopper)
MAX_PLANE = 56 * 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def instance_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor,
                            eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch instance norm of NCHW ``x`` with f32 statistics."""
    xf = x.float()
    mu = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mu).square().mean(dim=(2, 3), keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.float()[:, None, None] + bias.float()[:, None, None]
    return y.to(x.dtype)


_ENTRY = None


def _kernel_entry():
    global _ENTRY
    if _ENTRY is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _ENTRY = _build.entry("scflow_instance_norm_fwd",
                              [p, p, p, p, i, i, i, ctypes.c_float, i, p])
    return _ENTRY


def instance_norm_fwd(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Launch the CUDA kernel on contiguous NCHW ``x`` (f32 or bf16) with
    (C,) f32 ``scale``/``bias``; raise on anything it does not take."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        raise NotImplementedError("IN backward comes with the training slice")
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_fwd needs a CUDA tensor, got {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"expected contiguous 4-D f32/bf16 NCHW input, got "
                         f"{x.dtype} {tuple(x.shape)}")
    n, c, h, w = x.shape
    hw = h * w
    if hw % 8 or hw > MAX_PLANE or x.data_ptr() % 16:
        raise ValueError(f"plane {h}x{w} not a 16-byte-aligned multiple of 8 "
                         f"elements of at most {MAX_PLANE}")
    for v in (scale, bias):
        if (v.device != x.device or v.dtype != torch.float32
                or tuple(v.shape) != (c,) or not v.is_contiguous()):
            raise ValueError(f"scale/bias must be contiguous f32 ({c},) on "
                             f"{x.device}, got {v.dtype} {tuple(v.shape)}")
    y = torch.empty_like(x)
    err = _kernel_entry()(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        n * c, c, hw, eps, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "instance_norm_fwd")
    instance_norm_fwd.launches += 1
    return y


instance_norm_fwd.launches = 0


def instance_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Instance norm of NCHW ``x``: the kernel on CUDA, the plain version
    on the CPU."""
    if x.device.type == "cpu":
        return instance_norm_reference(x, scale, bias, eps)
    return instance_norm_fwd(x, scale, bias, eps)
