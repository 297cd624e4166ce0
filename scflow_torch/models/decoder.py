"""SCFlow decoder: recurrent GRU updates under a pose-induced-flow
constraint (port of ``scflow_tpu/models/decoder.py:35-262``).

The JAX ``nn.scan`` becomes a Python loop over iterations. Inside the loop
tensors are NCHW; the outputs keep the JAX layout, (T, N, H, W, C) with
the iteration axis first. ``lowres=True`` (the eval default) carries the
pose-induced flow at feature resolution, computed from 4-tap "effective
points", and rebuilds the full-resolution outputs of the last iteration
only; ``lowres=False`` carries the flow at image resolution, as training
runs it. Under autograd each iteration detaches the carried flow and mask
and the source pose, as the JAX ``_SCFlowIteration`` does with its detach
flags on; the options of the JAX decoder (``net_type``,
``rotation_mode``, ``depth_transform``, ``detach_depth_for_xy``,
``mask_flow``, ``mask_corr``, ``remat``) keep their names and defaults.
``remat`` recomputes each iteration in the backward pass
(``torch.utils.checkpoint``, non-reentrant) instead of keeping its
activations.

With a compute ``dtype`` (bf16) the pyramid levels are stored in it and
the GRU state, the motion encoder, the GRU, the heads' hidden convs, the
embeddings and the pose head's convs and FC layers compute in it; the
delta flow, the mask, the pose and all geometry stay f32.

``RAFTDecoder`` is the plain RAFT loop of the flow(→PnP) family (port of
``scflow_tpu/models/decoder.py:265-370``), in f32: convex upsampling with
the Basic net, bilinear with the others.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..geometry.flow import flow_from_pose_and_points
from ..geometry.projection import (depth_to_correspondences, pixel_grid,
                                   project_points)
from ..geometry.se3 import compose_delta_pose
from ..utils.profiling import span
from .corr import corr_lookup, correlation_pyramid
from .gru import ConvGRU
from .heads import FlowMaskEmbed, MotionEncoder, PoseHead, XHead
from .layers import downsample_flow, resize_bilinear_align_corners, upsample_flow

DEPTH_TRANSFORMS = ("exp", "linear")


@dataclasses.dataclass
class SCFlowOutputs:
    """Per-iteration sequences, leading axis = iteration (JAX layout)."""
    flow_from_pose: torch.Tensor      # (T, N, H, W, 2)
    flow_from_pred: torch.Tensor      # (T, N, H, W, 2)
    rotations: torch.Tensor           # (T, N, 3, 3)
    translations: torch.Tensor        # (T, N, 3)
    masks: torch.Tensor               # (T, N, H, W, 1)
    delta_rotations: torch.Tensor     # (T, N, 6 ortho6d | 4 quaternion)
    delta_translations: torch.Tensor  # (T, N, 3)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class SCFlowDecoder(nn.Module):
    """Shape-constrained recurrent decoder. The defaults are the shipped
    SCFlow recipe's: Basic net, ortho6d rotations, exp depth transform,
    depth detached in the x/y update, unmasked correlation and flow.
    ``feat_hw`` is the feature-map size; ``dtype`` the compute dtype."""

    def __init__(self, feat_hw: tuple[int, int], num_levels: int = 4,
                 radius: int = 4, iters: int = 8, num_class: int = 21,
                 h_channels: int = 128, cxt_channels: int = 128,
                 dtype: torch.dtype | None = None, net_type: str = "Basic",
                 rotation_mode: str = "ortho6d", depth_transform: str = "exp",
                 detach_depth_for_xy: bool = True, mask_flow: bool = False,
                 mask_corr: bool = False, remat: bool = False):
        super().__init__()
        if depth_transform not in DEPTH_TRANSFORMS:
            raise ValueError(f"unknown depth_transform {depth_transform!r}")
        self.num_levels = num_levels
        self.radius = radius
        self.iters = iters
        self.compute_dtype = dtype
        self.depth_transform = depth_transform
        self.detach_depth_for_xy = detach_depth_for_xy
        self.mask_flow = mask_flow
        self.mask_corr = mask_corr
        self.remat = remat
        self.encoder = MotionEncoder(num_levels * (2 * radius + 1) ** 2, dtype,
                                     net_type)
        self.gru = ConvGRU(h_channels, cxt_channels + self.encoder.out_channels,
                           dtype)
        self.flow_pred = XHead(h_channels, (256,), 2, "flow", dtype)
        self.mask_pred = XHead(h_channels, (256,), 1, "mask", dtype)
        self.delta_flow_encoder = FlowMaskEmbed(2, (128, 64), (7, 3), dtype)
        self.mask_encoder = FlowMaskEmbed(1, (64, 32), (3, 3), dtype)
        self.pose_pred = PoseHead(h_channels + 64 + 32, feat_hw, num_class,
                                  rotation_mode, dtype=dtype)

    def _iteration(self, h_feat, flow, mask, rot, trans, pyramid, cxt_feat,
                   label, k, geom, scale: int, invalid_flow_num: float,
                   lowres: bool):
        """One GRU + delta-pose update (the JAX ``_SCFlowIteration``):
        returns the new carry (h_feat, flow, mask, rot, trans) and this
        iteration's outputs in the order of :class:`SCFlowOutputs` (at
        ``lowres``: no pose flow or mask, the flow at feature size)."""
        flow, mask = flow.detach(), mask.detach()
        if lowres:
            flow_small = flow
        else:
            h_img, w_img = flow.shape[-2:]
            flow_small = downsample_flow(flow, scale)
        corr = corr_lookup(pyramid, flow_small, self.radius)
        if self.mask_corr:
            corr = corr * mask
        motion = self.encoder(corr,
                              flow_small * mask if self.mask_flow
                              else flow_small)
        h_feat = self.gru(h_feat, torch.cat([cxt_feat, motion], dim=1))
        delta_flow = self.flow_pred(h_feat)
        mask = torch.sigmoid(self.mask_pred(h_feat))
        dflow_feat = self.delta_flow_encoder(delta_flow)
        drot, dtrans = self.pose_pred(
            torch.cat([h_feat.to(dflow_feat.dtype), dflow_feat,
                       self.mask_encoder(mask)], dim=1), label)
        rot, trans = compose_delta_pose(
            drot, dtrans, rot.detach(), trans.detach(),
            depth_transform=self.depth_transform,
            detach_depth_for_xy=self.detach_depth_for_xy)
        flow_pred = flow_small + delta_flow
        if lowres:
            p_eff, w_eff, x_eff = geom
            n, _, hf, wf = w_eff.shape
            proj, _ = project_points(p_eff, k, rot, trans)
            proj = _nchw(proj.reshape(n, hf, wf, 2))
            flow = (w_eff * proj - x_eff) / scale
            return (h_feat, flow, mask, rot, trans), (
                None, flow_pred, rot, trans, None, drot, dtrans)
        points_3d, valid = geom
        pose_flow = flow_from_pose_and_points(
            rot, trans, k, points_3d, valid, invalid_num=invalid_flow_num)
        outs = (pose_flow, _nhwc(upsample_flow(flow_pred, scale)), rot, trans,
                _nhwc(resize_bilinear_align_corners(mask, (h_img, w_img))),
                drot, dtrans)
        return (h_feat, _nchw(pose_flow), mask, rot, trans), outs

    def forward(self, feat_render, feat_real, h_feat, cxt_feat, ref_rotation,
                ref_translation, depth, k, label,
                init_flow: torch.Tensor | None = None,
                invalid_flow_num: float = 0.0, iters: int | None = None,
                lowres: bool = False) -> SCFlowOutputs:
        """feat_render/feat_real (N, C, hf, wf), h_feat/cxt_feat
        (N, 128, hf, wf); ref pose (N, 3, 3)/(N, 3); depth (N, H, W);
        k (N, 3, 3); label (N,); init_flow (N, H, W, 2) in the JAX layout
        (default zeros; ``lowres`` starts from zeros, as in JAX);
        ``invalid_flow_num`` the pose flow of pixels without depth."""
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
            geom = (p_eff, w_eff, x_eff)
            flow = torch.zeros(n, 2, hf, wf, device=dev)
        else:
            geom = (points_3d, valid)
            flow = (torch.zeros(n, 2, h_img, w_img, device=dev)
                    if init_flow is None else _nchw(init_flow))
        carry = (h_feat, flow, torch.ones(n, 1, hf, wf, device=dev),
                 ref_rotation, ref_translation)
        step = self._iteration
        if self.remat and torch.is_grad_enabled():
            def step(*args):
                return checkpoint(self._iteration, *args, use_reentrant=False)

        seq = [[] for _ in dataclasses.fields(SCFlowOutputs)]
        for _ in range(num_iters):
            with span("decoder.iter"):
                carry, outs = step(*carry, pyramid, cxt_feat, label, k, geom,
                                   scale, invalid_flow_num, lowres)
            for acc, o in zip(seq, outs):
                acc.append(o)
        if lowres:
            # full-resolution outputs for the final iteration only
            _, _, mask, rot, trans = carry
            seq[0] = [flow_from_pose_and_points(
                rot, trans, k, points_3d, valid,
                invalid_num=invalid_flow_num)]
            seq[1] = [_nhwc(upsample_flow(seq[1][-1], scale))]
            seq[4] = [_nhwc(resize_bilinear_align_corners(mask,
                                                          (h_img, w_img)))]
        return SCFlowOutputs(*(torch.stack(v) for v in seq))


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
    """Plain RAFT decoder with, with ``predict_mask``, a per-iteration
    occlusion head (the JAX ``RAFTDecoder``). The Basic net upsamples flow
    and occlusion with learned convex weights (``mask_pred``); other nets
    have no weight head and upsample bilinearly (align corners, the flow
    scaled by the factor). Each iteration detaches the carried flow; the
    GRU state is not detached."""

    def __init__(self, num_levels: int = 4, radius: int = 4, iters: int = 12,
                 predict_mask: bool = False, h_channels: int = 128,
                 cxt_channels: int = 128, upsample_factor: int = 8,
                 net_type: str = "Basic"):
        super().__init__()
        self.num_levels = num_levels
        self.radius = radius
        self.iters = iters
        self.scale = upsample_factor
        self.encoder = MotionEncoder(num_levels * (2 * radius + 1) ** 2,
                                     net_type=net_type)
        self.gru = ConvGRU(h_channels, cxt_channels + self.encoder.out_channels)
        self.flow_pred = XHead(h_channels, (256,), 2, "flow")
        # convex-upsample weights: 9·scale² channels (reference ``mask_pred``)
        self.mask_pred = (XHead(h_channels, (256,), 9 * self.scale ** 2, "mask")
                          if net_type == "Basic" else None)
        self.occlusion_pred = (XHead(h_channels, (256,), 1, "mask")
                               if predict_mask else None)

    def forward(self, feat1, feat2, h_feat, cxt_feat,
                init_flow: torch.Tensor | None = None,
                iters: int | None = None):
        """feat1/feat2 (N, C, hf, wf), h_feat/cxt_feat (N, 128, hf, wf),
        init_flow (N, hf, wf, 2) in the JAX layout (default zeros).
        Returns (flows (T, N, H, W, 2), occlusions (T, N, H, W, 1)) at
        image resolution in the JAX layout; occlusions are zeros without
        the occlusion head, as in the JAX package."""
        n, _, hf, wf = feat1.shape
        s = self.scale
        num_iters = self.iters if iters is None else iters
        pyramid = correlation_pyramid(feat1, feat2, self.num_levels)
        flow = (torch.zeros(n, 2, hf, wf, device=feat1.device)
                if init_flow is None else _nchw(init_flow))
        flows, occs = [], []
        for _ in range(num_iters):
            with span("decoder.iter"):
                flow = flow.detach()
                corr = corr_lookup(pyramid, flow, self.radius)
                motion = self.encoder(corr, flow)
                h_feat = self.gru(h_feat, torch.cat([cxt_feat, motion], dim=1))
                flow = flow + self.flow_pred(h_feat)
                up_weights = None
                if self.mask_pred is not None:
                    up_weights = 0.25 * self.mask_pred(h_feat)
                    flows.append(_nhwc(convex_upsample(flow, up_weights, s)))
                else:
                    flows.append(_nhwc(upsample_flow(flow, s)))
                if self.occlusion_pred is None:
                    occs.append(flows[-1].new_zeros(n, hf * s, wf * s, 1))
                    continue
                occ = torch.sigmoid(self.occlusion_pred(h_feat))
                if up_weights is not None:
                    occs.append(_nhwc(convex_upsample(occ, up_weights, s,
                                                      1.0)))
                else:
                    occs.append(_nhwc(resize_bilinear_align_corners(
                        occ, (hf * s, wf * s))))
        return torch.stack(flows), torch.stack(occs)
