"""Flow-based image warping (port of ``scflow_tpu/utils/warp.py``): the
reference's ``Warp`` module (models/utils/warp.py:32-105) and its
``simple_forward_warp`` splat (models/utils/utils.py:81-97). Images are
(..., C, H, W); flow is (..., H, W, 2) in xy order, as elsewhere in the
port."""
from __future__ import annotations

import torch

from ..geometry.flow import coords_from_flow
from ..geometry.projection import bilinear_sample


def backward_warp(image: torch.Tensor, flow: torch.Tensor,
                  return_mask: bool = False):
    """Warp the target ``image`` (..., C, H, W) back to the source frame
    with source→target ``flow``: out[p] = image[p + flow[p]], bilinear,
    zero outside. With ``return_mask`` also the (..., H, W) bool mask of
    landing points inside the frame."""
    h, w = image.shape[-2:]
    flat = coords_from_flow(flow).reshape(flow.shape[:-3] + (h * w, 2))
    out = bilinear_sample(image, flat).reshape(image.shape)
    if not return_mask:
        return out
    valid = ((flat[..., 0] >= 0) & (flat[..., 0] <= w - 1)
             & (flat[..., 1] >= 0) & (flat[..., 1] <= h - 1))
    return out, valid.reshape(flow.shape[:-1])


def forward_warp_splat(image: torch.Tensor, flow: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Nearest-pixel forward splat of ``image`` (N, C, H, W) along ``flow``
    (N, H, W, 2); ``mask`` (N, H, W) keeps the source pixels above 0.5.
    Each source pixel lands on its flow target rounded half to even; a
    pixel landing outside the frame is dropped. Where several land on one
    pixel the one of the largest row-major source index wins, on every
    device (a scatter with repeated indices has no defined order on CUDA):
    the winner is chosen by ``scatter_reduce("amax")`` over source indices
    and its values gathered."""
    n, c, h, w = image.shape
    coords = coords_from_flow(flow)
    tx = torch.round(coords[..., 0]).long()
    ty = torch.round(coords[..., 1]).long()
    inb = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
    if mask is not None:
        inb = inb & (mask > 0.5)
    dest = torch.where(inb, ty * w + tx, h * w).reshape(n, h * w)
    src = torch.arange(h * w, device=image.device).expand(n, h * w)
    winner = torch.full((n, h * w + 1), -1, dtype=torch.long,
                        device=image.device)
    winner = winner.scatter_reduce(1, dest, src, "amax")[:, :h * w]
    vals = image.reshape(n, c, h * w).gather(
        2, winner.clamp_min(0)[:, None, :].expand(n, c, h * w))
    return torch.where(winner[:, None, :] >= 0, vals, 0.0).reshape(
        n, c, h, w).to(image.dtype)
