"""Shared building blocks in NCHW (port of ``scflow_tpu/models/layers.py``).

Parameter names follow the reference torch modules (mmcv ``ConvModule``:
``conv`` plus a norm named by its kind ``bn``/``in``/``gn``;
ResNet ``BasicBlock``: ``conv1``/``{norm}1``/``conv2``/``{norm}2``/
``downsample``), which is the layout ``scflow_tpu``'s checkpoint converter
reads. Convolutions pad by ``k // 2`` on each side as the flax modules do.

``dtype`` is the compute dtype (``torch.bfloat16`` or None for the
parameters' float32), as the flax modules' ``dtype``: parameters stay
float32; a conv or dense layer casts its input, weight and bias to it and
returns it; a norm computes its statistics and the normalisation in
float32 and rounds once to it at the output (instance norm: to its
input's type, which is the compute dtype).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.instance_norm import instance_norm


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``dtype`` (flax ``nn.Conv(dtype=…)``):
    input, weight and bias cast to it, output in it."""

    def __init__(self, *args, dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` (flax ``nn.Dense(dtype=…)``)."""

    def __init__(self, cin: int, cout: int,
                 dtype: torch.dtype | None = None):
        super().__init__(cin, cout)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class FusedInstanceNorm(nn.Module):
    """Instance norm with affine ``weight``/``bias`` in plain PyTorch
    (statistics in f32, the input's type out)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.weight, self.bias, self.eps)


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` computed in f32 (of the input's values) and rounded
    once to the compute ``dtype`` (default: the input's)."""

    def __init__(self, groups: int, channels: int, eps: float = 1e-5,
                 dtype: torch.dtype | None = None):
        super().__init__(groups, channels, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(self.compute_dtype or x.dtype)


class BatchNorm(nn.BatchNorm2d):
    """Batch norm that trains as flax's ``nn.BatchNorm(momentum=0.9)``.

    Eval mode is ``nn.BatchNorm2d``'s (running statistics). Train mode
    normalises with the f32 batch mean and the biased variance
    E[x²] − E[x]² (clamped at 0, flax's fast variance) over N, H, W, and
    moves ``running_mean``/``running_var`` by ``momentum`` (0.1) toward
    them, the biased variance included. An optional (N,) ``sample_mask``
    (> 0.5 counts) keeps padded samples out of the statistics; they are
    still normalised. Both modes compute in f32 and round once to the
    compute ``dtype`` (default: the input's).
"""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.1, dtype: torch.dtype | None = None):
        super().__init__(channels, eps=eps, momentum=momentum)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor,
                sample_mask: torch.Tensor | None = None) -> torch.Tensor:
        out_dtype = self.compute_dtype or x.dtype
        if not self.training:
            return super().forward(x.float()).to(out_dtype)
        xf = x.float()
        if sample_mask is None:
            mean = xf.mean(dim=(0, 2, 3))
            mean2 = xf.square().mean(dim=(0, 2, 3))
        else:
            m = (torch.ones(x.shape[0], dtype=xf.dtype, device=x.device)
                 if sample_mask is None else (sample_mask > 0.5).to(xf.dtype))
            m = m[:, None, None, None]
            count = m.sum() * (x.shape[2] * x.shape[3])
            sums = torch.cat([
                (xf * m).sum(dim=(0, 2, 3)),
                (xf.square() * m).sum(dim=(0, 2, 3)), count[None]])
            c = x.shape[1]
            mean, mean2 = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
        var = (mean2 - mean.square()).clamp_min(0.0)
        with torch.no_grad():      # flax's order: 0.9·running + 0.1·batch
            for buf, v in ((self.running_mean, mean), (self.running_var, var)):
                buf.mul_(1.0 - self.momentum).add_(v * self.momentum)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = ((xf - mean[:, None, None]) * mul[:, None, None]
             + self.bias[:, None, None])
        return y.to(out_dtype)


def make_norm(kind: str, channels: int, gn_groups: int = 32,
              dtype: torch.dtype | None = None) -> nn.Module:
    """'in' | 'bn' | 'gn' norm with torch-default eps (BN uses its running
    statistics in eval mode, flax's batch statistics in train mode)."""
    if kind == "in":
        return FusedInstanceNorm(channels)
    if kind == "bn":
        return BatchNorm(channels, eps=1e-5, momentum=0.1, dtype=dtype)
    if kind == "gn":
        return GroupNorm(gn_groups, channels, eps=1e-5, dtype=dtype)
    raise ValueError(f"unknown norm {kind!r}")


def apply_norm(norm: nn.Module, x: torch.Tensor,
               sample_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Run ``norm``; only batch norm reads ``sample_mask``."""
    if isinstance(norm, BatchNorm):
        return norm(x, sample_mask)
    return norm(x)


def conv2d(cin: int, cout: int, kernel, stride: int = 1, bias: bool = True,
           dtype: torch.dtype | None = None) -> Conv2d:
    """Conv with flax's explicit ``k // 2`` padding per side."""
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
    return Conv2d(cin, cout, (kh, kw), stride, padding=(kh // 2, kw // 2),
                  bias=bias, dtype=dtype)


class ConvBlock(nn.Module):
    """conv → (norm) → (ReLU): the mmcv ``ConvModule`` equivalent."""

    def __init__(self, cin: int, cout: int, kernel=3, stride: int = 1,
                 norm: str | None = None, act: bool = True,
                 gn_groups: int = 32, dtype: torch.dtype | None = None):
        super().__init__()
        self.conv = conv2d(cin, cout, kernel, stride, dtype=dtype)
        self.norm = norm           # the norm module is named by its kind
        if norm:
            self.add_module(norm, make_norm(norm, cout, gn_groups, dtype))
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm:
            x = getattr(self, self.norm)(x)
        return F.relu(x) if self.act else x


class BasicBlock(nn.Module):
    """ResNet BasicBlock with reference names (``conv1``, ``in1``, …)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, norm: str = "in",
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.abbr = norm
        self.conv1 = conv2d(cin, cout, 3, stride, dtype=dtype)
        self.add_module(f"{self.abbr}1", make_norm(norm, cout, dtype=dtype))
        self.conv2 = conv2d(cout, cout, 3, dtype=dtype)
        self.add_module(f"{self.abbr}2", make_norm(norm, cout, dtype=dtype))
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                conv2d(cin, cout, 1, stride, dtype=dtype),
                make_norm(norm, cout, dtype=dtype))

    def forward(self, x: torch.Tensor,
                sample_mask: torch.Tensor | None = None) -> torch.Tensor:
        out = F.relu(apply_norm(getattr(self, f"{self.abbr}1"),
                                self.conv1(x), sample_mask))
        out = apply_norm(getattr(self, f"{self.abbr}2"), self.conv2(out),
                         sample_mask)
        identity = x
        if self.downsample is not None:
            conv, norm = self.downsample
            identity = apply_norm(norm, conv(x), sample_mask)
        return F.relu(out + identity)


def resize_bilinear_align_corners(x: torch.Tensor,
                                  out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` with align_corners=True semantics:
    output pixel i samples input coordinate i·(H_in − 1)/(H_out − 1)."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=True)


def downsample_flow(flow: torch.Tensor, scale: int) -> torch.Tensor:
    """(N, 2, H, W) flow to 1/scale resolution, values divided by scale."""
    h, w = flow.shape[-2] // scale, flow.shape[-1] // scale
    return resize_bilinear_align_corners(flow, (h, w)) / scale


def upsample_flow(flow: torch.Tensor, scale: int) -> torch.Tensor:
    """(N, 2, h, w) flow to full resolution, values multiplied by scale."""
    h, w = flow.shape[-2] * scale, flow.shape[-1] * scale
    return resize_bilinear_align_corners(flow, (h, w)) * scale
