"""Instance norm: CUDA forward and backward kernels and their plain PyTorch
versions, joined by a ``torch.autograd.Function``.

Port of ``scflow_tpu/ops/fused_norm.py``. Per (sample, channel) of an
NCHW activation: f32 mean and biased variance over H·W, then
``(x − μ)·rsqrt(var + eps)·scale + bias`` cast back to the type of x. The
backward is the JAX package's ``_bwd`` formula. :func:`instance_norm`
launches ``csrc/instance_norm.cu`` on CUDA tensors (the forward kernel,
and the backward kernel when a gradient is asked for) and runs
:func:`instance_norm_reference` / :func:`instance_norm_bwd_reference` on
CPU tensors.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from ..utils.profiling import kernel_work
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' forms by the code their entry reports: it picks the vector
# form (one CTA per plane, 16-byte vectors), the warp form (one warp per
# small plane, in registers), the general form (a CTA or a warp per
# plane, 16-byte slots cut at each plane's own alignment, any plane up to
# 57,344 elements; its backward is one launch), the cluster form (a plane
# over 2-8 CTAs) or the split form (a plane past a cluster cut into
# slices, two launches) from the plane's size and the pointers
# (``csrc/instance_norm.cu``)
_FORMS = ("vector", "general", "cluster", "split", "warp")
# operations per element: forward sum, centred square, normalise, affine;
# backward statistics 4, the two sums 5, dx 7
OPS_PER_ELEM, BWD_OPS_PER_ELEM = 8, 16


def fwd_work(x: torch.Tensor) -> tuple[int, int]:
    """(operations, bytes) of a forward on ``x``, whatever runs it: x read
    and y written once."""
    return x.numel() * OPS_PER_ELEM, 2 * x.numel() * x.element_size()


def bwd_work(x: torch.Tensor) -> tuple[int, int]:
    """(operations, bytes) of a backward on ``x``: x and g read and dx
    written once, scale read and dscale, dbias written once."""
    return (x.numel() * BWD_OPS_PER_ELEM,
            3 * x.numel() * x.element_size() + 3 * x.shape[1] * 4)


def _stats_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 statistics, or wider where x is wider (float64 gradchecks)."""
    return torch.promote_types(x.dtype, torch.float32)


def instance_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor,
                            eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch instance norm of NCHW ``x`` with f32 statistics."""
    with kernel_work("instance_norm_fwd", lambda: fwd_work(x)):
        xf = x.to(_stats_dtype(x))
        mu = xf.mean(dim=(2, 3), keepdim=True)
        var = (xf - mu).square().mean(dim=(2, 3), keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = (y * scale.to(xf.dtype)[:, None, None]
             + bias.to(xf.dtype)[:, None, None])
        return y.to(x.dtype)


def instance_norm_bwd_reference(x: torch.Tensor, g: torch.Tensor,
                                scale: torch.Tensor, eps: float = 1e-5):
    """Plain PyTorch backward of :func:`instance_norm_reference` for the
    output gradient ``g``: (dx in the type of x, dscale, dbias in the type
    of scale), the formula of the JAX package's ``_bwd``."""
    with kernel_work("instance_norm_bwd", lambda: bwd_work(x)):
        xf = x.to(_stats_dtype(x))
        gf = g.to(xf.dtype)
        mu = xf.mean(dim=(2, 3), keepdim=True)
        var = (xf - mu).square().mean(dim=(2, 3), keepdim=True)
        inv = torch.rsqrt(var + eps)
        xhat = (xf - mu) * inv
        dscale = (gf * xhat).sum(dim=(0, 2, 3))
        dbias = gf.sum(dim=(0, 2, 3))
        gs = gf * scale.to(xf.dtype)[:, None, None]
        m1 = gs.mean(dim=(2, 3), keepdim=True)
        m2 = (gs * xhat).mean(dim=(2, 3), keepdim=True)
        dx = inv * (gs - m1 - xhat * m2)
        return dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype)


_ENTRIES: dict = {}


def _kernel_entry(name: str, argtypes: list):
    if name not in _ENTRIES:
        _ENTRIES[name] = _build.entry(name, argtypes)
    return _ENTRIES[name]


def _check_plane(x: torch.Tensor, what: str) -> None:
    """Device, type, rank and contiguity: the kernels take every plane
    size and every element-aligned base."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"expected contiguous 4-D f32/bf16 NCHW input, got "
                         f"{x.dtype} {tuple(x.shape)}")


def _count(fn, code: int, dtype: torch.dtype) -> None:
    """One launch of ``fn`` of the form its entry reported: ``launches``,
    and ``form_launches[form, dtype]`` with form one of ``_FORMS`` and
    dtype ``f32`` or ``bf16``."""
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    fn.launches += 1
    fn.form_launches[_FORMS[code], dt] += 1


_WORK_SIZES: dict = {}


def _work(x: torch.Tensor, backward: bool):
    """The f32 scratch the entry needs for x's planes, as it reports it
    (the split form's per-slice sums), or None where it needs none. The
    size is asked once per (planes, H·W, direction, dtype)."""
    n, c, h, w = x.shape
    key = (n * c, h * w, int(backward), _DTYPES[x.dtype])
    if key not in _WORK_SIZES:
        i = ctypes.c_int
        _WORK_SIZES[key] = _kernel_entry("scflow_instance_norm_work",
                                         [i, i, i, i])(*key)
    size = _WORK_SIZES[key]
    if size < 0:
        raise ValueError(f"instance norm: {tuple(x.shape)} needs more "
                         f"scratch than an int counts")
    return (torch.empty(size, device=x.device, dtype=torch.float32)
            if size else None)


_TICKETS: dict = {}


def _tickets(x: torch.Tensor, stream: torch.cuda.Stream) -> torch.Tensor:
    """The ticket counter of the general form's backward for x's device
    and ``stream``: one int32, zeroed once at first use and returned to 0
    by every launch. One per (device, stream), so that
    launches on two streams never draw from one counter."""
    key = (x.device.index, stream.cuda_stream)
    if key not in _TICKETS:      # zeroed on the device's current stream
        _TICKETS[key] = torch.zeros(1, device=x.device, dtype=torch.int32)
    return _TICKETS[key]


def _check_channel_vectors(x: torch.Tensor, *vs: torch.Tensor) -> None:
    c = x.shape[1]
    for v in vs:
        if (v.device != x.device or v.dtype != torch.float32
                or tuple(v.shape) != (c,) or not v.is_contiguous()):
            raise ValueError(f"scale/bias must be contiguous f32 ({c},) on "
                             f"{x.device}, got {v.dtype} {tuple(v.shape)}")


def instance_norm_fwd(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Launch the forward kernel on contiguous NCHW ``x`` (f32 or bf16) with
    (C,) f32 ``scale``/``bias``; raise on anything it does not take. It
    records no autograd graph: gradients go through :func:`instance_norm`."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        raise RuntimeError("instance_norm_fwd records no graph; call "
                           "instance_norm for gradients")
    _check_plane(x, "instance_norm_fwd")
    _check_channel_vectors(x, scale, bias)
    n, c, h, w = x.shape
    with kernel_work("instance_norm_fwd", lambda: fwd_work(x)):
        y = torch.empty_like(x)
        work = _work(x, backward=False)
        form = ctypes.c_int(-1)
        p, i = ctypes.c_void_p, ctypes.c_int
        err = _kernel_entry("scflow_instance_norm_fwd",
                            [p, p, p, p, p, i, i, i, ctypes.c_float, i,
                             ctypes.POINTER(i), p])(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            None if work is None else work.data_ptr(), n * c, c, h * w, eps,
            _DTYPES[x.dtype], ctypes.byref(form),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "instance_norm_fwd")
    _count(instance_norm_fwd, form.value, x.dtype)
    return y


instance_norm_fwd.launches = 0
instance_norm_fwd.form_launches = collections.Counter()


def instance_norm_bwd(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                      eps: float = 1e-5):
    """Launch the backward kernel: (dx, dscale, dbias) for the forward's
    input ``x`` and output gradient ``g`` (contiguous NCHW, both f32 or both
    bf16) and (C,) f32 ``scale``; raise on anything it does not take."""
    _check_plane(x, "instance_norm_bwd")
    _check_plane(g, "instance_norm_bwd")
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g {g.dtype} {tuple(g.shape)} must match x "
                         f"{x.dtype} {tuple(x.shape)}")
    _check_channel_vectors(x, scale)
    n, c, h, w = x.shape
    with kernel_work("instance_norm_bwd", lambda: bwd_work(x)):
        dx = torch.empty_like(x)
        part = torch.empty(2, n * c, device=x.device, dtype=torch.float32)
        dscale = torch.empty(c, device=x.device, dtype=torch.float32)
        dbias = torch.empty_like(dscale)
        work = _work(x, backward=True)
        stream = torch.cuda.current_stream(x.device)
        form = ctypes.c_int(-1)
        p, i = ctypes.c_void_p, ctypes.c_int
        err = _kernel_entry("scflow_instance_norm_bwd",
                            [p, p, p, p, p, p, p, p, p, i, i, i,
                             ctypes.c_float, i, ctypes.POINTER(i), p])(
            x.data_ptr(), g.data_ptr(), scale.data_ptr(), dx.data_ptr(),
            part.data_ptr(), None if work is None else work.data_ptr(),
            _tickets(x, stream).data_ptr(), dscale.data_ptr(),
            dbias.data_ptr(), n * c, c, h * w, eps, _DTYPES[x.dtype],
            ctypes.byref(form), stream.cuda_stream)
    _build.check(err, "instance_norm_bwd")
    _count(instance_norm_bwd, form.value, x.dtype)
    return dx, dscale, dbias


instance_norm_bwd.launches = 0
instance_norm_bwd.form_launches = collections.Counter()


class _InstanceNorm(torch.autograd.Function):
    """Saves (x, scale) as the JAX ``_fwd`` does; the kernels on CUDA
    tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        if x.device.type == "cpu":
            return instance_norm_reference(x, scale, bias, eps)
        return instance_norm_fwd(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dscale, dbias = instance_norm_bwd_reference(x, g, scale,
                                                            ctx.eps)
        else:
            dx, dscale, dbias = instance_norm_bwd(x, g.contiguous(), scale,
                                                  ctx.eps)
        return dx, dscale, dbias, None


def instance_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Instance norm of NCHW ``x`` with a gradient for x, scale and bias:
    the kernels on CUDA, the plain versions on the CPU."""
    return _InstanceNorm.apply(x, scale, bias, eps)
