"""RAFT feature/context encoder, Basic arch, NCHW (port of
``scflow_tpu/models/encoder.py``): 7×7/2 stem, three 2-block ResNet stages
(64/96/128 channels, strides 1/2/2) and a 1×1 output conv, stride 8 in all.
IN for the feature encoders, BN for the context encoder. With a compute
``dtype`` the input is cast to it and every layer, ``conv2`` included,
computes in it."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BasicBlock, apply_norm, conv2d, make_norm

# Basic arch: stem channels, then (channels, blocks, stride) per stage
STEM_CHANNELS = 64
STAGES = ((64, 2, 1), (96, 2, 2), (128, 2, 2))


class RAFTEncoder(nn.Module):
    """Stride-8 CNN encoder with the reference torch parameter names
    (``conv1``, ``in1``/``bn1``, ``res_layer{1,2,3}.{0,1}``, ``conv2``)."""

    def __init__(self, out_channels: int = 256, norm: str = "in",
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.abbr = norm
        self.compute_dtype = dtype
        self.conv1 = conv2d(3, STEM_CHANNELS, 7, 2, dtype=dtype)
        self.add_module(f"{self.abbr}1",
                        make_norm(norm, STEM_CHANNELS, dtype=dtype))
        cin = STEM_CHANNELS
        for i, (ch, nb, st) in enumerate(STAGES):
            layer = [BasicBlock(cin if b == 0 else ch, ch,
                                st if b == 0 else 1, norm, dtype)
                     for b in range(nb)]
            self.add_module(f"res_layer{i + 1}", nn.Sequential(*layer))
            cin = ch
        self.num_stages = len(STAGES)
        self.conv2 = conv2d(cin, out_channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor,
                sample_mask: torch.Tensor | None = None) -> torch.Tensor:
        """(N, 3, H, W) images → (N, out_channels, H/8, W/8) features.
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
