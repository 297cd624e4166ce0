"""Prediction heads in NCHW (port of ``scflow_tpu/models/heads.py``):
motion encoder, flow/mask heads, flow/mask embeddings and the delta-pose
head, with the reference torch parameter names. ``dtype`` is the compute
dtype of ``layers``; the flow/mask predict convs and the pose head's
output layers stay float32, as in the flax heads."""
from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from .layers import ConvBlock, Linear, conv2d

# net_type: (corr channels, corr kernels, flow channels, flow kernels, out)
MOTION = {
    "Basic": ((256, 192), (1, 3), (128, 64), (7, 3), 126),
    "Large": ((256, 192), (1, 3), (128, 64), (7, 3), 126),
    "Small": ((96,), (1,), (64, 32), (7, 3), 80),
}


class MotionEncoder(nn.Module):
    """corr + flow → motion features at the widths of ``net_type``; the
    output ends with the raw flow (cast to the compute dtype, as both
    inputs are)."""

    def __init__(self, corr_channels: int, dtype: torch.dtype | None = None,
                 net_type: str = "Basic"):
        super().__init__()
        if net_type not in MOTION:
            raise ValueError(f"unknown net_type {net_type!r}")
        corr_ch, corr_k, flow_ch, flow_k, out_ch = MOTION[net_type]
        self.compute_dtype = dtype
        self.corr_net = nn.Sequential(*[
            ConvBlock(cin, ch, kk, dtype=dtype) for cin, ch, kk in
            zip((corr_channels,) + corr_ch[:-1], corr_ch, corr_k)])
        self.flow_net = nn.Sequential(*[
            ConvBlock(cin, ch, kk, dtype=dtype) for cin, ch, kk in
            zip((2,) + flow_ch[:-1], flow_ch, flow_k)])
        self.out_net = nn.Sequential(
            ConvBlock(corr_ch[-1] + flow_ch[-1], out_ch, 3, dtype=dtype))
        self.out_channels = out_ch + 2

    def forward(self, corr: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None:
            corr, flow = corr.to(self.compute_dtype), flow.to(self.compute_dtype)
        out = self.out_net(torch.cat([self.corr_net(corr),
                                      self.flow_net(flow)], dim=1))
        return torch.cat([out, flow], dim=1)


class XHead(nn.Module):
    """3×3 ReLU convs in the compute dtype, then a float32 predict conv
    (1×1 for 'mask', else 3×3) on their output cast to float32."""

    def __init__(self, in_channels: int, feat_channels: Sequence[int] = (256,),
                 out_channels: int = 2, kind: str = "flow",
                 dtype: torch.dtype | None = None):
        super().__init__()
        chans = (in_channels, *feat_channels)
        self.layers = nn.Sequential(*[ConvBlock(a, b, 3, dtype=dtype)
                                      for a, b in zip(chans, chans[1:])])
        self.predict_layer = conv2d(chans[-1], out_channels,
                                    1 if kind == "mask" else 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.predict_layer(self.layers(x).float())


class FlowMaskEmbed(nn.Sequential):
    """ReLU conv embedding of the delta flow or the mask for the pose head;
    the input is cast to the compute dtype."""

    def __init__(self, in_channels: int, channels: Sequence[int] = (128, 64),
                 kernels: Sequence[int] = (7, 3),
                 dtype: torch.dtype | None = None):
        chans = (in_channels, *channels)
        super().__init__(*[ConvBlock(a, b, kk, dtype=dtype) for a, b, kk in
                           zip(chans, chans[1:], kernels)])
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        return super().forward(x)


# the identity rotation of each rotation mode; its length is the pose
# head's rotation outputs per class
_IDENTITY = {"ortho6d": [1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
             "quaternion": [0.0, 0.0, 0.0, 1.0]}
ROT_DIM = {mode: len(v) for mode, v in _IDENTITY.items()}


def identity_rotation_bias(rotation_mode: str = "ortho6d",
                           num_class: int = 1) -> torch.Tensor:
    """Pose-head rotation bias that predicts the identity rotation for
    every class: ortho6d (1, 0, 0, 0, 1, 0) or quaternion xyzw (0, 0, 0, 1)."""
    if rotation_mode not in _IDENTITY:
        raise ValueError(f"unsupported rotation mode {rotation_mode!r}")
    return torch.tensor(_IDENTITY[rotation_mode] * num_class)


class PoseHead(nn.Module):
    """Delta-pose regression: three stride-2 GN+ReLU convs, two FC layers
    on the NCHW flatten (all in the compute dtype), then float32
    rotation/translation linears (6 ortho6d or 4 quaternion rotation
    outputs per class, ``rotation_mode``); with ``num_class > 1`` the
    ``label`` row of the per-class outputs is kept.

    ``in_hw`` is the feature map size, which fixes the first FC's width."""

    def __init__(self, in_channels: int, in_hw: tuple[int, int],
                 num_class: int = 1, rotation_mode: str = "ortho6d",
                 conv_channels: Sequence[int] = (128, 128, 128),
                 fc_channels: Sequence[int] = (1024, 256),
                 dtype: torch.dtype | None = None):
        super().__init__()
        if rotation_mode not in ROT_DIM:
            raise ValueError(f"unsupported rotation mode {rotation_mode!r}")
        self.num_class = num_class
        self.rotation_mode = rotation_mode
        self.rot_dim = ROT_DIM[rotation_mode]
        chans = (in_channels, *conv_channels)
        self.conv_layers = nn.ModuleList([
            ConvBlock(a, b, 3, stride=2, norm="gn", dtype=dtype)
            for a, b in zip(chans, chans[1:])])
        h, w = in_hw
        for _ in conv_channels:
            h, w = (h + 1) // 2, (w + 1) // 2
        fcs = (conv_channels[-1] * h * w, *fc_channels)
        self.fc_layers = nn.ModuleList([
            nn.Sequential(Linear(a, b, dtype), nn.ReLU())
            for a, b in zip(fcs, fcs[1:])])
        self.rotation_pred = nn.Linear(fcs[-1], self.rot_dim * num_class)
        self.translation_pred = nn.Linear(fcs[-1], 3 * num_class)

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        for conv in self.conv_layers:
            x = conv(x)
        x = x.flatten(1)
        for fc in self.fc_layers:
            x = fc(x)
        x = x.float()
        rot = self.rotation_pred(x)
        trans = self.translation_pred(x)
        if self.num_class > 1:
            rows = torch.arange(x.shape[0], device=x.device)
            rot = rot.reshape(-1, self.num_class, self.rot_dim)[rows, label]
            trans = trans.reshape(-1, self.num_class, 3)[rows, label]
        return rot, trans
