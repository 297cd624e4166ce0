"""Convolutional GRU, 'SeqConv' variant (port of
``scflow_tpu/models/gru.py``): two chained GRU passes with (1, 5) then
(5, 1) kernels. Parameter names follow the reference (``conv_z.{i}.conv``).
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import ConvBlock

_KERNELS = ((1, 5), (5, 1))


class ConvGRU(nn.Module):

    def __init__(self, h_channels: int = 128, x_channels: int = 256):
        super().__init__()
        cin = h_channels + x_channels

        def convs():
            return nn.ModuleList([ConvBlock(cin, h_channels, kern, act=False)
                                  for kern in _KERNELS])

        self.conv_z, self.conv_r, self.conv_q = convs(), convs(), convs()

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """h (N, Ch, H, W) hidden state, x (N, Cx, H, W) input → new h."""
        for conv_z, conv_r, conv_q in zip(self.conv_z, self.conv_r,
                                          self.conv_q):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(conv_z(hx))
            r = torch.sigmoid(conv_r(hx))
            q = torch.tanh(conv_q(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h
