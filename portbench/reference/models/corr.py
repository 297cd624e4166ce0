"""All-pairs correlation pyramid and bilinear lookup (port of
``scflow_tpu/models/corr.py:148-241``).

Layout: level l is (N, P, H/2^l, W/2^l) with P = H·W query pixels of the
render features (the JAX ``_pm`` levels are (N, Hl, Wl, P): the same
values, transposed). The (2r+1)² tap lookup gathers the two bilinear
corners per axis with the JAX package's weights max(0, 1 − |t − i|) and
zero weight off the level (grid_sample's zero padding, align_corners=True).
``grid_sample`` itself is not used: its normalise/unnormalise round trip
moves the weights by up to ~1e-5 at 32×32 features.

bf16 (the JAX package's bf16 path): the pyramid is accumulated, scaled and
pooled in f32 and only its stored levels are rounded to bf16; the lookup
of a bf16 level rounds the bilinear weights to bf16, sums the x taps in
f32, rounds that to bf16, and sums the y taps in f32 (bf16 products are
exact in f32). The lookup's output is f32 in both types.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def correlation_pyramid(feat_render: torch.Tensor, feat_real: torch.Tensor,
                        num_levels: int = 4,
                        dtype: torch.dtype | None = None) -> list[torch.Tensor]:
    """<f_render[p], f_real[i, j]> / sqrt(C), avg-pooled 2×2 per level, in
    f32 (features of another type are widened first), each level stored in
    ``dtype`` (default f32).

    feat_render/feat_real: (N, C, H, W). Returns ``num_levels`` tensors
    (N, P, H/2^l, W/2^l)."""
    n, c, h, w = feat_render.shape
    corr = torch.bmm(feat_render.float().reshape(n, c, h * w).transpose(1, 2),
                     feat_real.float().reshape(n, c, h * w))
    corr = (corr / math.sqrt(c)).reshape(n, h * w, h, w)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        prev = pyramid[-1]
        hl, wl = prev.shape[-2:]
        pooled = F.avg_pool2d(prev.reshape(n * h * w, 1, hl, wl), 2)
        pyramid.append(pooled.reshape(n, h * w, hl // 2, wl // 2))
    if dtype is not None:
        pyramid = [p.to(dtype) for p in pyramid]
    return pyramid


def _corners(t: torch.Tensor, size: int):
    """Bilinear corners of coordinates ``t`` on an axis of ``size`` pixels:
    [(index, weight), …], weight 0 where the corner is off the axis. A
    size-1 axis gives its one pixel weight 1 for every coordinate, as
    torch's align_corners mapping collapses it (the JAX size-1 rule)."""
    if size == 1:
        return [(torch.zeros_like(t, dtype=torch.long), torch.ones_like(t))]
    i0 = torch.floor(t)
    i1 = i0 + 1.0
    out = []
    for i, wgt in ((i0, 1.0 - (t - i0)), (i1, 1.0 - (i1 - t))):
        inside = (i >= 0) & (i <= size - 1)
        out.append((i.clamp(0, size - 1).long(), torch.where(inside, wgt, 0.0)))
    return out


def corr_lookup(pyramid: list[torch.Tensor], flow: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """Sample a (2r+1)² neighbourhood of every level at the flow targets.

    flow (N, 2, H, W) at feature resolution. Returns (N, L·(2r+1)², H, W)
    in f32. Tap channel (a, b) samples (x + d_a, y + d_b): the x offset is
    the major tap axis, as in the reference checkpoints.
    """
    n, _, h, w = flow.shape
    b = n * h * w
    k = 2 * radius + 1
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=flow.dtype, device=flow.device),
        torch.arange(w, dtype=flow.dtype, device=flow.device), indexing="ij")
    cx = (xs + flow[:, 0]).reshape(b, 1)
    cy = (ys + flow[:, 1]).reshape(b, 1)
    d = torch.arange(-radius, radius + 1, dtype=flow.dtype, device=flow.device)
    out = []
    for lvl, corr in enumerate(pyramid):
        hl, wl = corr.shape[-2:]
        flat = corr.reshape(b, hl * wl)
        x_corners = _corners(cx / 2.0 ** lvl + d, wl)          # (B, Kx) each
        y_corners = _corners(cy / 2.0 ** lvl + d, hl)          # (B, Ky) each
        low = corr.dtype if corr.dtype != torch.float32 else None
        if low is not None:      # weights rounded to the level's type
            x_corners = [(i, wt.to(low).float()) for i, wt in x_corners]
            y_corners = [(i, wt.to(low).float()) for i, wt in y_corners]
        samp = 0.0
        for iy, wy in y_corners:
            row = 0.0            # Σ_x c[y, x]·wx, then Σ_y row·wy, as in JAX
            for ix, wx in x_corners:
                idx = (iy[:, None, :] * wl + ix[:, :, None]).reshape(b, k * k)
                row = row + (flat.gather(1, idx).reshape(b, k, k).float()
                             * wx[:, :, None])
            if low is not None:
                row = row.to(low).float()
            samp = samp + row * wy[:, None, :]                  # (B, Kx, Ky)
        out.append(samp.reshape(n, h * w, k * k))
    return torch.cat(out, dim=-1).transpose(1, 2).reshape(n, -1, h, w)


def local_correlation(feat1: torch.Tensor, feat2: torch.Tensor,
                      max_displacement: int = 4,
                      normalize: bool = True) -> torch.Tensor:
    """Windowed correlation of two (N, C, H, W) feature maps → (N, (2r+1)²,
    H, W), r = ``max_displacement``: channel (dy, dx), row-major over
    [-r, r]², holds Σ_c feat1[p]·feat2[p + (dy, dx)] / √C, zero past the
    frame (the mmcv ``Correlation`` op of the reference's ``CorrBlock``,
    models/utils/corr_block.py:9-109; unused by the shipped configs).
    ``normalize`` first divides each pixel's features by their L2 norm
    plus 1e-6."""
    if normalize:
        feat1 = feat1 / (torch.linalg.vector_norm(feat1, dim=1, keepdim=True)
                         + 1e-6)
        feat2 = feat2 / (torch.linalg.vector_norm(feat2, dim=1, keepdim=True)
                         + 1e-6)
    _, c, h, w = feat1.shape
    r = max_displacement
    pad = F.pad(feat2, (r, r, r, r))
    out = [(feat1 * pad[:, :, r + dy:r + dy + h, r + dx:r + dx + w]).sum(1)
           for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    return torch.stack(out, dim=1) / math.sqrt(c)
