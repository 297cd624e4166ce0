"""RAFT feature/context encoder, NCHW (port of
``scflow_tpu/models/encoder.py``): a 7×7 stem (stride 2, or 1 with
``stride4``), 2-block ResNet stages and a 1×1 output conv. ``net_type``
picks the widths of the JAX ``_ARCH`` table: 'Basic' (64; 64/96/128,
strides 1/2/2: stride 8), 'Small' (32; 8/16/24, stride 8) or 'Large' (64;
64/96, strides 1/2: stride 4). IN for the feature encoders, BN for the
context encoder. With a compute ``dtype`` the input is cast to it and
every layer, ``conv2`` included, computes in it."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BasicBlock, apply_norm, conv2d, make_norm

# net_type: (stem channels, (channels, blocks, stride) per stage)
ARCH = {
    "Basic": (64, ((64, 2, 1), (96, 2, 2), (128, 2, 2))),
    "Small": (32, ((8, 2, 1), (16, 2, 2), (24, 2, 2))),
    "Large": (64, ((64, 2, 1), (96, 2, 2))),
}


def encoder_stride(net_type: str = "Basic", stride4: bool = False) -> int:
    """Input pixels per feature pixel of a ``net_type`` encoder."""
    if net_type not in ARCH:
        raise ValueError(f"unknown net_type {net_type!r}")
    stride = 1 if stride4 else 2
    for _, _, st in ARCH[net_type][1]:
        stride *= st
    return stride


class RAFTEncoder(nn.Module):
    """CNN encoder with the reference torch parameter names (``conv1``,
    ``in1``/``bn1``, ``res_layer{1,2,3}.{0,1}``, ``conv2``)."""

    def __init__(self, out_channels: int = 256, norm: str = "in",
                 dtype: torch.dtype | None = None, net_type: str = "Basic",
                 stride4: bool = False):
        super().__init__()
        self.stride = encoder_stride(net_type, stride4)
        stem, stages = ARCH[net_type]
        self.abbr = norm
        self.compute_dtype = dtype
        self.conv1 = conv2d(3, stem, 7, 1 if stride4 else 2, dtype=dtype)
        self.add_module(f"{self.abbr}1", make_norm(norm, stem, dtype=dtype))
        cin = stem
        for i, (ch, nb, st) in enumerate(stages):
            layer = [BasicBlock(cin if b == 0 else ch, ch,
                                st if b == 0 else 1, norm, dtype)
                     for b in range(nb)]
            self.add_module(f"res_layer{i + 1}", nn.Sequential(*layer))
            cin = ch
        self.num_stages = len(stages)
        self.conv2 = conv2d(cin, out_channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor,
                sample_mask: torch.Tensor | None = None) -> torch.Tensor:
        """(N, 3, H, W) images → (N, out_channels, H/s, W/s) features,
        s = ``self.stride``.
        ``sample_mask`` (N,) keeps padded samples out of train-mode batch
        statistics (BN only; IN is per sample)."""
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        x = F.relu(apply_norm(getattr(self, f"{self.abbr}1"), self.conv1(x),
                              sample_mask))
        for i in range(self.num_stages):
            for block in getattr(self, f"res_layer{i + 1}"):
                x = block(x, sample_mask)
        return self.conv2(x)
