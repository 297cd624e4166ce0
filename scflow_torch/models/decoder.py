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
"""
from __future__ import annotations

import dataclasses

import torch
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
    ``feat_hw`` is the feature-map size."""

    def __init__(self, feat_hw: tuple[int, int], num_levels: int = 4,
                 radius: int = 4, iters: int = 8, num_class: int = 21,
                 h_channels: int = 128, cxt_channels: int = 128):
        super().__init__()
        self.num_levels = num_levels
        self.radius = radius
        self.iters = iters
        self.encoder = MotionEncoder(num_levels * (2 * radius + 1) ** 2)
        self.gru = ConvGRU(h_channels, cxt_channels + self.encoder.out_channels)
        self.flow_pred = XHead(h_channels, (256,), 2, "flow")
        self.mask_pred = XHead(h_channels, (256,), 1, "mask")
        self.delta_flow_encoder = FlowMaskEmbed(2, (128, 64), (7, 3))
        self.mask_encoder = FlowMaskEmbed(1, (64, 32), (3, 3))
        self.pose_pred = PoseHead(h_channels + 64 + 32, feat_hw, num_class)

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

        pyramid = correlation_pyramid(feat_render, feat_real, self.num_levels)
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
            drot, dtrans = self.pose_pred(
                torch.cat([h_feat, self.delta_flow_encoder(delta_flow),
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
