"""SCFlow decoder: recurrent GRU updates under a pose-induced-flow
constraint (port of ``scflow_tpu/models/decoder.py:35-262``).

The JAX ``nn.scan`` becomes a Python loop over iterations. Inside the loop
tensors are NCHW; the outputs keep the JAX layout, (T, N, H, W, C) with
the iteration axis first. ``lowres=True`` (the eval default) carries the
pose-induced flow at feature resolution, computed from 4-tap "effective
points", and rebuilds the full-resolution outputs of the last iteration
only; ``lowres=False`` carries the flow at image resolution, as training
runs it. Under autograd each iteration detaches the carried flow and mask
and the source pose, and the depth update reaches x and y detached, as
the JAX ``_SCFlowIteration`` does with all detach flags on.

With a compute ``dtype`` (bf16) the pyramid levels are stored in it and
the GRU state, the motion encoder, the GRU, the heads' hidden convs, the
embeddings and the pose head's convs and FC layers compute in it; the
delta flow, the mask, the pose and all geometry stay f32.

``RAFTDecoder`` is the plain RAFT loop of the flow(→PnP) family (port of
``scflow_tpu/models/decoder.py:265-370``), in f32.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..geometry.flow import flow_from_pose_and_points
from ..geometry.projection import (depth_to_correspondences, pixel_grid,
                                   project_points)
from ..geometry.se3 import compose_delta_pose
from .corr import corr_lookup, correlation_pyramid
from .gru import ConvGRU
from .heads import FlowMaskEmbed, MotionEncoder, PoseHead, XHead
from .layers import downsample_flow, resize_bilinear_align_corners, upsample_flow


@dataclasses.dataclass
class SCFlowOutputs:
    """Per-iteration sequences, leading axis = iteration (JAX layout)."""
    flow_from_pose: torch.Tensor      # (T, N, H, W, 2)
    flow_from_pred: torch.Tensor      # (T, N, H, W, 2)
    rotations: torch.Tensor           # (T, N, 3, 3)
    translations: torch.Tensor        # (T, N, 3)
    masks: torch.Tensor               # (T, N, H, W, 1)
    delta_rotations: torch.Tensor     # (T, N, 6)
    delta_translations: torch.Tensor  # (T, N, 3)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class SCFlowDecoder(nn.Module):
    """Shape-constrained recurrent decoder as the shipped SCFlow recipe runs
    it: Basic net, ortho6d rotations, exp depth transform, all detach flags
    on, unmasked correlation and flow, invalid flow 0, zero initial flow.
    ``feat_hw`` is the feature-map size; ``dtype`` the compute dtype."""

    def __init__(self, feat_hw: tuple[int, int], num_levels: int = 4,
                 radius: int = 4, iters: int = 8, num_class: int = 21,
                 h_channels: int = 128, cxt_channels: int = 128,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.num_levels = num_levels
        self.radius = radius
        self.iters = iters
        self.compute_dtype = dtype
        self.encoder = MotionEncoder(num_levels * (2 * radius + 1) ** 2, dtype)
        self.gru = ConvGRU(h_channels, cxt_channels + self.encoder.out_channels,
                           dtype)
        self.flow_pred = XHead(h_channels, (256,), 2, "flow", dtype)
        self.mask_pred = XHead(h_channels, (256,), 1, "mask", dtype)
        self.delta_flow_encoder = FlowMaskEmbed(2, (128, 64), (7, 3), dtype)
        self.mask_encoder = FlowMaskEmbed(1, (64, 32), (3, 3), dtype)
        self.pose_pred = PoseHead(h_channels + 64 + 32, feat_hw, num_class,
                                  dtype=dtype)

    def forward(self, feat_render, feat_real, h_feat, cxt_feat, ref_rotation,
                ref_translation, depth, k, label, iters: int | None = None,
                lowres: bool = False) -> SCFlowOutputs:
        """feat_render/feat_real (N, C, hf, wf), h_feat/cxt_feat
        (N, 128, hf, wf); ref pose (N, 3, 3)/(N, 3); depth (N, H, W);
        k (N, 3, 3); label (N,)."""
        n, h_img, w_img = depth.shape
        hf, wf = feat_render.shape[-2:]
        scale = h_img // hf
        num_iters = self.iters if iters is None else iters
        dev = depth.device

        pyramid = correlation_pyramid(feat_render, feat_real, self.num_levels,
                                      self.compute_dtype)
        if self.compute_dtype is not None:
            h_feat = h_feat.to(self.compute_dtype)
        _, points_3d, valid = depth_to_correspondences(
            depth, k, ref_rotation, ref_translation)
        if lowres:
            # bilinear downsample of the valid-masked points and pixel grid
            vf = valid.float()[:, None]
            w_eff = resize_bilinear_align_corners(vf, (hf, wf))
            p_w = resize_bilinear_align_corners(_nchw(points_3d) * vf, (hf, wf))
            p_eff = _nhwc(p_w / w_eff.clamp_min(1e-12)).reshape(n, hf * wf, 3)
            grid = _nchw(pixel_grid(h_img, w_img, torch.float32, dev)[None])
            x_eff = resize_bilinear_align_corners(grid * vf, (hf, wf))
            flow = torch.zeros(n, 2, hf, wf, device=dev)
        else:
            flow = torch.zeros(n, 2, h_img, w_img, device=dev)
        mask = torch.ones(n, 1, hf, wf, device=dev)
        rot, trans = ref_rotation, ref_translation

        seq = {f.name: [] for f in dataclasses.fields(SCFlowOutputs)}
        for _ in range(num_iters):
            flow, mask = flow.detach(), mask.detach()
            flow_small = flow if lowres else downsample_flow(flow, scale)
            corr = corr_lookup(pyramid, flow_small, self.radius)
            motion = self.encoder(corr, flow_small)
            h_feat = self.gru(h_feat, torch.cat([cxt_feat, motion], dim=1))
            delta_flow = self.flow_pred(h_feat)
            mask = torch.sigmoid(self.mask_pred(h_feat))
            dflow_feat = self.delta_flow_encoder(delta_flow)
            drot, dtrans = self.pose_pred(
                torch.cat([h_feat.to(dflow_feat.dtype), dflow_feat,
                           self.mask_encoder(mask)], dim=1), label)
            rot, trans = compose_delta_pose(
                drot, dtrans, rot.detach(), trans.detach(),
                depth_transform="exp", detach_depth_for_xy=True)
            if lowres:
                proj, _ = project_points(p_eff, k, rot, trans)
                proj = _nchw(proj.reshape(n, hf, wf, 2))
                flow = (w_eff * proj - x_eff) / scale
            else:
                pose_flow = flow_from_pose_and_points(
                    rot, trans, k, points_3d, valid, invalid_num=0.0)
                seq["flow_from_pose"].append(pose_flow)
                seq["flow_from_pred"].append(_nhwc(
                    upsample_flow(flow_small + delta_flow, scale)))
                seq["masks"].append(_nhwc(
                    resize_bilinear_align_corners(mask, (h_img, w_img))))
                flow = _nchw(pose_flow)
            seq["rotations"].append(rot)
            seq["translations"].append(trans)
            seq["delta_rotations"].append(drot)
            seq["delta_translations"].append(dtrans)

        if lowres:
            # full-resolution outputs for the final iteration only
            seq["flow_from_pose"] = [flow_from_pose_and_points(
                rot, trans, k, points_3d, valid, invalid_num=0.0)]
            seq["flow_from_pred"] = [_nhwc(
                upsample_flow(flow_small + delta_flow, scale))]
            seq["masks"] = [_nhwc(
                resize_bilinear_align_corners(mask, (h_img, w_img)))]
        return SCFlowOutputs(**{k_: torch.stack(v) for k_, v in seq.items()})


def convex_upsample(x: torch.Tensor, weights: torch.Tensor, scale: int,
                    multiplier: float | None = None) -> torch.Tensor:
    """RAFT convex upsampling ×``scale`` of NCHW ``x`` (N, C, h, w) with
    learned weights (N, 9·scale², h, w): per output pixel a softmax over 9
    taps (the weight channels laid out (9, scale, scale), taps dy-major) of
    the zero-padded 3×3 neighbourhood of ``multiplier``·x (default
    ``scale``, the flow rescale; 1 for occlusion). Returns
    (N, C, h·scale, w·scale)."""
    n, c, h, w = x.shape
    mult = float(scale) if multiplier is None else multiplier
    win = torch.softmax(weights.reshape(n, 9, scale, scale, h, w), dim=1)
    pad = F.pad(x * mult, (1, 1, 1, 1))
    patches = torch.stack([pad[:, :, dy:dy + h, dx:dx + w]
                           for dy in range(3) for dx in range(3)], dim=1)
    up = torch.einsum("nkabhw,nkchw->nchawb", win, patches)
    return up.reshape(n, c, h * scale, w * scale)


class RAFTDecoder(nn.Module):
    """Plain RAFT decoder with convex upsampling and, with
    ``predict_mask``, a per-iteration occlusion head upsampled with the
    same convex weights (the JAX ``RAFTDecoder`` with the Basic net). Each
    iteration detaches the carried flow; the GRU state is not detached."""

    def __init__(self, num_levels: int = 4, radius: int = 4, iters: int = 12,
                 predict_mask: bool = False, h_channels: int = 128,
                 cxt_channels: int = 128, upsample_factor: int = 8):
        super().__init__()
        self.num_levels = num_levels
        self.radius = radius
        self.iters = iters
        self.scale = upsample_factor
        self.encoder = MotionEncoder(num_levels * (2 * radius + 1) ** 2)
        self.gru = ConvGRU(h_channels, cxt_channels + self.encoder.out_channels)
        self.flow_pred = XHead(h_channels, (256,), 2, "flow")
        # convex-upsample weights: 9·scale² channels (reference ``mask_pred``)
        self.mask_pred = XHead(h_channels, (256,), 9 * self.scale ** 2, "mask")
        self.occlusion_pred = (XHead(h_channels, (256,), 1, "mask")
                               if predict_mask else None)

    def forward(self, feat1, feat2, h_feat, cxt_feat,
                iters: int | None = None):
        """feat1/feat2 (N, C, hf, wf), h_feat/cxt_feat (N, 128, hf, wf).
        Returns (flows (T, N, H, W, 2), occlusions (T, N, H, W, 1)) at
        image resolution in the JAX layout; occlusions are zeros without
        the occlusion head, as in the JAX package."""
        n, _, hf, wf = feat1.shape
        s = self.scale
        num_iters = self.iters if iters is None else iters
        pyramid = correlation_pyramid(feat1, feat2, self.num_levels)
        flow = torch.zeros(n, 2, hf, wf, device=feat1.device)
        flows, occs = [], []
        for _ in range(num_iters):
            flow = flow.detach()
            corr = corr_lookup(pyramid, flow, self.radius)
            motion = self.encoder(corr, flow)
            h_feat = self.gru(h_feat, torch.cat([cxt_feat, motion], dim=1))
            flow = flow + self.flow_pred(h_feat)
            up_weights = 0.25 * self.mask_pred(h_feat)
            flows.append(_nhwc(convex_upsample(flow, up_weights, s)))
            if self.occlusion_pred is None:
                occs.append(flows[-1].new_zeros(n, hf * s, wf * s, 1))
            else:
                occ = torch.sigmoid(self.occlusion_pred(h_feat))
                occs.append(_nhwc(convex_upsample(occ, up_weights, s, 1.0)))
        return torch.stack(flows), torch.stack(occs)
