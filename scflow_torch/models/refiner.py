"""Refiner networks (port of ``scflow_tpu/models/refiner.py``).

``SCFlowRefiner``: a render and a real feature encoder (one module,
shared, unless ``separate_encoder`` gives the real images a second IN
encoder, ``real_encoder``), a BN context encoder whose output splits into
the tanh'd GRU state and the ReLU'd context, and the SCFlow decoder;
``dtype`` is the compute dtype (bf16 or None for f32; parameters stay
f32). ``RAFTRefiner``: the same encoders (f32) and the plain RAFT decoder;
its pose comes from PnP on the flow (``models/flow_pose.py``).
``net_type`` ('Basic', 'Small', 'Large') sets the widths of all three
encoders and of the decoder's motion encoder, as in JAX. Parameter names
are the reference torch ones."""
from __future__ import annotations

import torch
from torch import nn

from ..utils.profiling import span
from .decoder import RAFTDecoder, SCFlowDecoder, SCFlowOutputs
from .encoder import RAFTEncoder, encoder_stride


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


# the real images' encoder: the one ``separate_encoder`` registers (a
# module assignment goes to ``_modules``, past the property), else the
# render encoder
_real_encoder = property(
    lambda self: self._modules.get("real_encoder", self.render_encoder))


class SCFlowRefiner(nn.Module):

    def __init__(self, num_class: int = 21, h_channels: int = 128,
                 cxt_channels: int = 128, feat_channels: int = 256,
                 num_levels: int = 4, radius: int = 4, iters: int = 8,
                 image_size: tuple[int, int] = (256, 256),
                 dtype: torch.dtype | None = None,
                 separate_encoder: bool = False, net_type: str = "Basic",
                 rotation_mode: str = "ortho6d", depth_transform: str = "exp",
                 detach_depth_for_xy: bool = True, mask_flow: bool = False,
                 mask_corr: bool = False, remat: bool = False):
        super().__init__()
        self.h_channels = h_channels
        self.separate_encoder = separate_encoder
        self.render_encoder = RAFTEncoder(feat_channels, norm="in",
                                          dtype=dtype, net_type=net_type)
        if separate_encoder:
            self.real_encoder = RAFTEncoder(feat_channels, norm="in",
                                            dtype=dtype, net_type=net_type)
        self.context = RAFTEncoder(h_channels + cxt_channels, norm="bn",
                                   dtype=dtype, net_type=net_type)
        stride = encoder_stride(net_type)
        feat_hw = (image_size[0] // stride, image_size[1] // stride)
        self.decoder = SCFlowDecoder(
            feat_hw, num_levels=num_levels, radius=radius, iters=iters,
            num_class=num_class, h_channels=h_channels,
            cxt_channels=cxt_channels, dtype=dtype, net_type=net_type,
            rotation_mode=rotation_mode, depth_transform=depth_transform,
            detach_depth_for_xy=detach_depth_for_xy, mask_flow=mask_flow,
            mask_corr=mask_corr, remat=remat)

    real_encoder = _real_encoder

    def extract_feat(self, render_images: torch.Tensor,
                     real_images: torch.Tensor,
                     sample_valid: torch.Tensor | None = None):
        """(render feat, real feat, GRU h, context) from NCHW images.
        ``sample_valid`` (N,) keeps padded samples out of the context
        encoder's train-mode BN statistics (train mode is ``self.training``,
        flax's ``train=True``)."""
        feat_render = self.render_encoder(render_images)
        feat_real = self.real_encoder(real_images)
        cxt = self.context(render_images, sample_valid)
        h_feat, cxt_feat = torch.split(
            cxt, [self.h_channels, cxt.shape[1] - self.h_channels], dim=1)
        return feat_render, feat_real, torch.tanh(h_feat), torch.relu(cxt_feat)

    def forward(self, render_images, real_images, ref_rotation,
                ref_translation, depth, k, label, iters: int | None = None,
                lowres: bool = False,
                sample_valid: torch.Tensor | None = None) -> SCFlowOutputs:
        """render/real images (N, H, W, 3) normalised, ref pose (N, 3, 3) /
        (N, 3), depth (N, H, W), k (N, 3, 3), label (N,), optional
        sample_valid (N,). Returns the decoder's (T, N, ...) sequences in
        the JAX layout."""
        with span("encode"):
            feats = self.extract_feat(_nchw(render_images),
                                      _nchw(real_images), sample_valid)
        with span("decoder"):
            return self.decoder(*feats, ref_rotation, ref_translation, depth,
                                k, label, invalid_flow_num=0.0, iters=iters,
                                lowres=lowres)


class RAFTRefiner(nn.Module):
    """RAFT flow(+occlusion) refiner network: an IN feature encoder (shared
    unless ``separate_encoder``), BN context encoder on the render side,
    RAFT decoder; ``predict_mask`` adds the occlusion head."""

    def __init__(self, h_channels: int = 128, cxt_channels: int = 128,
                 feat_channels: int = 256, num_levels: int = 4,
                 radius: int = 4, iters: int = 12, predict_mask: bool = True,
                 separate_encoder: bool = False, net_type: str = "Basic"):
        super().__init__()
        self.h_channels = h_channels
        self.separate_encoder = separate_encoder
        self.render_encoder = RAFTEncoder(feat_channels, norm="in",
                                          net_type=net_type)
        if separate_encoder:
            self.real_encoder = RAFTEncoder(feat_channels, norm="in",
                                            net_type=net_type)
        self.context = RAFTEncoder(h_channels + cxt_channels, norm="bn",
                                   net_type=net_type)
        # upsampled by 8, the JAX decoder's factor whatever the net
        self.decoder = RAFTDecoder(num_levels=num_levels, radius=radius,
                                   iters=iters, predict_mask=predict_mask,
                                   h_channels=h_channels,
                                   cxt_channels=cxt_channels,
                                   net_type=net_type)

    real_encoder = _real_encoder

    def forward(self, render_images: torch.Tensor, real_images: torch.Tensor,
                iters: int | None = None,
                sample_valid: torch.Tensor | None = None):
        """render/real images (N, H, W, 3) normalised → (flows (T, N, H, W,
        2), occlusions (T, N, H, W, 1)).

        Multiview broadcast: either side may be one unbatched (H, W, 3)
        image; it is encoded once and its features broadcast against the
        other side's batch (the context encoder then sees the one render,
        without ``sample_valid``). ``sample_valid`` (N,) keeps padded
        samples out of the context encoder's train-mode BN statistics."""
        if render_images.dim() == 3 and real_images.dim() == 3:
            raise ValueError("at most one side may be unbatched "
                             "(multiview broadcast)")
        with span("encode"):
            if render_images.dim() == 3:
                n = real_images.shape[0]
                one = _nchw(render_images[None])
                feat_render = self.render_encoder(one).expand(n, -1, -1, -1)
                cxt = self.context(one).expand(n, -1, -1, -1)
            else:
                one = _nchw(render_images)
                feat_render = self.render_encoder(one)
                cxt = self.context(one, sample_valid)
            if real_images.dim() == 3:
                n = render_images.shape[0]
                feat_real = self.real_encoder(
                    _nchw(real_images[None])).expand(n, -1, -1, -1)
            else:
                feat_real = self.real_encoder(_nchw(real_images))
            h_feat, cxt_feat = torch.split(
                cxt, [self.h_channels, cxt.shape[1] - self.h_channels], dim=1)
            h_feat, cxt_feat = torch.tanh(h_feat), torch.relu(cxt_feat)
        with span("decoder"):
            return self.decoder(feat_render, feat_real, h_feat, cxt_feat,
                                iters=iters)
