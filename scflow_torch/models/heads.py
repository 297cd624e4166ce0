"""Prediction heads in NCHW (port of ``scflow_tpu/models/heads.py``):
motion encoder, flow/mask heads, flow/mask embeddings and the delta-pose
head, with the reference torch parameter names."""
from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from .layers import ConvBlock, conv2d

# Basic net: (corr channels, corr kernels, flow channels, flow kernels, out)
_MOTION = ((256, 192), (1, 3), (128, 64), (7, 3), 126)


class MotionEncoder(nn.Module):
    """corr + flow → motion features; the output ends with the raw flow."""

    def __init__(self, corr_channels: int):
        super().__init__()
        corr_ch, corr_k, flow_ch, flow_k, out_ch = _MOTION
        self.corr_net = nn.Sequential(*[
            ConvBlock(cin, ch, kk) for cin, ch, kk in
            zip((corr_channels,) + corr_ch[:-1], corr_ch, corr_k)])
        self.flow_net = nn.Sequential(*[
            ConvBlock(cin, ch, kk) for cin, ch, kk in
            zip((2,) + flow_ch[:-1], flow_ch, flow_k)])
        self.out_net = nn.Sequential(
            ConvBlock(corr_ch[-1] + flow_ch[-1], out_ch, 3))
        self.out_channels = out_ch + 2

    def forward(self, corr: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        out = self.out_net(torch.cat([self.corr_net(corr),
                                      self.flow_net(flow)], dim=1))
        return torch.cat([out, flow], dim=1)


class XHead(nn.Module):
    """3×3 ReLU convs, then a predict conv (1×1 for 'mask', else 3×3)."""

    def __init__(self, in_channels: int, feat_channels: Sequence[int] = (256,),
                 out_channels: int = 2, kind: str = "flow"):
        super().__init__()
        chans = (in_channels, *feat_channels)
        self.layers = nn.Sequential(*[ConvBlock(a, b, 3)
                                      for a, b in zip(chans, chans[1:])])
        self.predict_layer = conv2d(chans[-1], out_channels,
                                    1 if kind == "mask" else 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.predict_layer(self.layers(x))


class FlowMaskEmbed(nn.Sequential):
    """ReLU conv embedding of the delta flow or the mask for the pose head."""

    def __init__(self, in_channels: int, channels: Sequence[int] = (128, 64),
                 kernels: Sequence[int] = (7, 3)):
        chans = (in_channels, *channels)
        super().__init__(*[ConvBlock(a, b, kk) for a, b, kk in
                           zip(chans, chans[1:], kernels)])


ROT_DIM = 6      # ortho6d rotations


def identity_rotation_bias(num_class: int = 1) -> torch.Tensor:
    """Pose-head rotation bias that predicts the identity (ortho6d) for
    every class."""
    return torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0] * num_class)


class PoseHead(nn.Module):
    """Delta-pose regression: three stride-2 GN+ReLU convs, two FC layers
    on the NCHW flatten, then ortho6d rotation/translation linears; with
    ``num_class > 1`` the ``label`` row of the per-class outputs is kept.

    ``in_hw`` is the feature map size, which fixes the first FC's width."""

    def __init__(self, in_channels: int, in_hw: tuple[int, int],
                 num_class: int = 1,
                 conv_channels: Sequence[int] = (128, 128, 128),
                 fc_channels: Sequence[int] = (1024, 256)):
        super().__init__()
        self.num_class = num_class
        chans = (in_channels, *conv_channels)
        self.conv_layers = nn.ModuleList([
            ConvBlock(a, b, 3, stride=2, norm="gn")
            for a, b in zip(chans, chans[1:])])
        h, w = in_hw
        for _ in conv_channels:
            h, w = (h + 1) // 2, (w + 1) // 2
        fcs = (conv_channels[-1] * h * w, *fc_channels)
        self.fc_layers = nn.ModuleList([
            nn.Sequential(nn.Linear(a, b), nn.ReLU())
            for a, b in zip(fcs, fcs[1:])])
        self.rotation_pred = nn.Linear(fcs[-1], ROT_DIM * num_class)
        self.translation_pred = nn.Linear(fcs[-1], 3 * num_class)

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        for conv in self.conv_layers:
            x = conv(x)
        x = x.flatten(1)
        for fc in self.fc_layers:
            x = fc(x)
        rot = self.rotation_pred(x)
        trans = self.translation_pred(x)
        if self.num_class > 1:
            rows = torch.arange(x.shape[0], device=x.device)
            rot = rot.reshape(-1, self.num_class, ROT_DIM)[rows, label]
            trans = trans.reshape(-1, self.num_class, 3)[rows, label]
        return rot, trans
