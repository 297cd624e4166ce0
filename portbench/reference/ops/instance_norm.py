"""Plain instance norm of NCHW tensors: f32 statistics, the biased
variance, the affine scale and bias, the input's type out."""
from __future__ import annotations

import torch


def instance_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mu = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mu).square().mean(dim=(2, 3), keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.to(xf.dtype)[:, None, None] + bias.to(xf.dtype)[:, None, None]
    return y.to(x.dtype)
