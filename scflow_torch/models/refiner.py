"""SCFlow refiner network (port of ``scflow_tpu/models/refiner.py:19-104``):
a render/real feature encoder (one module, shared), a BN context encoder
whose output splits into the tanh'd GRU state and the ReLU'd context, and
the SCFlow decoder. Parameter names are the reference torch ones."""
from __future__ import annotations

import torch
from torch import nn

from .decoder import SCFlowDecoder, SCFlowOutputs
from .encoder import RAFTEncoder

STRIDE = 8


class SCFlowRefiner(nn.Module):

    def __init__(self, num_class: int = 21, h_channels: int = 128,
                 cxt_channels: int = 128, feat_channels: int = 256,
                 num_levels: int = 4, radius: int = 4, iters: int = 8,
                 image_size: tuple[int, int] = (256, 256)):
        super().__init__()
        self.h_channels = h_channels
        self.render_encoder = RAFTEncoder(feat_channels, norm="in")
        self.context = RAFTEncoder(h_channels + cxt_channels, norm="bn")
        feat_hw = (image_size[0] // STRIDE, image_size[1] // STRIDE)
        self.decoder = SCFlowDecoder(
            feat_hw, num_levels=num_levels, radius=radius, iters=iters,
            num_class=num_class, h_channels=h_channels,
            cxt_channels=cxt_channels)

    @property
    def real_encoder(self) -> RAFTEncoder:
        """The real-image encoder shares the render encoder's weights."""
        return self.render_encoder

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
        def nchw(x):
            return x.permute(0, 3, 1, 2).contiguous()

        feats = self.extract_feat(nchw(render_images), nchw(real_images),
                                  sample_valid)
        return self.decoder(*feats, ref_rotation, ref_translation, depth, k,
                            label, iters=iters, lowres=lowres)
