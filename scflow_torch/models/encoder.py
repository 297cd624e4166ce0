"""RAFT feature/context encoder, Basic arch, NCHW (port of
``scflow_tpu/models/encoder.py``): 7×7/2 stem, three 2-block ResNet stages
(64/96/128 channels, strides 1/2/2) and a 1×1 output conv, stride 8 in all.
IN for the feature encoders, BN for the context encoder."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BasicBlock, conv2d, make_norm

# Basic arch: stem channels, then (channels, blocks, stride) per stage
STEM_CHANNELS = 64
STAGES = ((64, 2, 1), (96, 2, 2), (128, 2, 2))


class RAFTEncoder(nn.Module):
    """Stride-8 CNN encoder with the reference torch parameter names
    (``conv1``, ``in1``/``bn1``, ``res_layer{1,2,3}.{0,1}``, ``conv2``)."""

    def __init__(self, out_channels: int = 256, norm: str = "in"):
        super().__init__()
        self.abbr = norm
        self.conv1 = conv2d(3, STEM_CHANNELS, 7, 2)
        self.add_module(f"{self.abbr}1", make_norm(norm, STEM_CHANNELS))
        cin = STEM_CHANNELS
        for i, (ch, nb, st) in enumerate(STAGES):
            layer = [BasicBlock(cin if b == 0 else ch, ch,
                                st if b == 0 else 1, norm) for b in range(nb)]
            self.add_module(f"res_layer{i + 1}", nn.Sequential(*layer))
            cin = ch
        self.num_stages = len(STAGES)
        self.conv2 = conv2d(cin, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) images → (N, out_channels, H/8, W/8) features."""
        x = F.relu(getattr(self, f"{self.abbr}1")(self.conv1(x)))
        for i in range(self.num_stages):
            x = getattr(self, f"res_layer{i + 1}")(x)
        return self.conv2(x)
