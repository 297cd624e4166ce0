"""Shared building blocks in NCHW (port of ``scflow_tpu/models/layers.py``).

Parameter names follow the reference torch modules (mmcv ``ConvModule``:
``conv`` plus a norm named by its kind ``bn``/``in``/``gn``;
ResNet ``BasicBlock``: ``conv1``/``{norm}1``/``conv2``/``{norm}2``/
``downsample``), which is the layout ``scflow_tpu``'s checkpoint converter
reads. Convolutions pad by ``k // 2`` on each side as the flax modules do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_norm import instance_norm


class FusedInstanceNorm(nn.Module):
    """Instance norm with affine ``weight``/``bias``: the CUDA kernel on
    every call on the card, its plain version on the CPU."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.weight, self.bias, self.eps)


def make_norm(kind: str, channels: int, gn_groups: int = 32) -> nn.Module:
    """'in' | 'bn' | 'gn' norm with torch-default eps (BN uses its running
    statistics in eval mode)."""
    if kind == "in":
        return FusedInstanceNorm(channels)
    if kind == "bn":
        return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)
    if kind == "gn":
        return nn.GroupNorm(gn_groups, channels, eps=1e-5)
    raise ValueError(f"unknown norm {kind!r}")


def conv2d(cin: int, cout: int, kernel, stride: int = 1,
           bias: bool = True) -> nn.Conv2d:
    """Conv with flax's explicit ``k // 2`` padding per side."""
    kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
    return nn.Conv2d(cin, cout, (kh, kw), stride, padding=(kh // 2, kw // 2),
                     bias=bias)


class ConvBlock(nn.Module):
    """conv → (norm) → (ReLU): the mmcv ``ConvModule`` equivalent."""

    def __init__(self, cin: int, cout: int, kernel=3, stride: int = 1,
                 norm: str | None = None, act: bool = True,
                 gn_groups: int = 32):
        super().__init__()
        self.conv = conv2d(cin, cout, kernel, stride)
        self.norm = norm           # the norm module is named by its kind
        if norm:
            self.add_module(norm, make_norm(norm, cout, gn_groups))
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm:
            x = getattr(self, self.norm)(x)
        return F.relu(x) if self.act else x


class BasicBlock(nn.Module):
    """ResNet BasicBlock with reference names (``conv1``, ``in1``, …)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, norm: str = "in"):
        super().__init__()
        self.abbr = norm
        self.conv1 = conv2d(cin, cout, 3, stride)
        self.add_module(f"{self.abbr}1", make_norm(norm, cout))
        self.conv2 = conv2d(cout, cout, 3)
        self.add_module(f"{self.abbr}2", make_norm(norm, cout))
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(conv2d(cin, cout, 1, stride),
                                            make_norm(norm, cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(getattr(self, f"{self.abbr}1")(self.conv1(x)))
        out = getattr(self, f"{self.abbr}2")(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
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
