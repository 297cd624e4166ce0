"""General ResNet backbone in NCHW (port of ``scflow_tpu/models/backbone.py``).

The reference's ResNet family (models/backbone/resnet.py:95-674:
Bottleneck, ResNet, ResNetV1d): depths 18/34/50/101/152, the optional
deep (V1d) stem, and the stage outputs named by ``out_indices``. The
shipped SCFlow configs use only ``BasicBlock`` (in ``RAFTEncoder``); no
train or eval path reaches this module.

Parameter names are the reference ``resnet.py``'s: ``conv1``/``{norm}1``
(the plain stem), ``stem.0``, ``stem.1``, ``stem.3``, … (the deep stem, a
``Sequential`` of conv, norm and ReLU), ``layer{s}.{b}.conv{j}`` /
``{norm}{j}`` and ``layer{s}.{b}.downsample.0/1``; ``{norm}`` is ``bn``,
``in`` or ``gn``. Every convolution has a bias, as the JAX package's
``ConvBlock`` (``use_bias=True``); the reference's have none.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BasicBlock, apply_norm, conv2d, make_norm


class Bottleneck(nn.Module):
    """The 1-3-1 bottleneck block (reference resnet.py:95-300): width
    ``features``, output ``expansion``·features channels."""
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 norm: str = "bn", dtype: torch.dtype | None = None):
        super().__init__()
        self.abbr = norm
        out = features * self.expansion
        for j, (a, b, k, s) in enumerate(((cin, features, 1, 1),
                                          (features, features, 3, stride),
                                          (features, out, 1, 1)), 1):
            self.add_module(f"conv{j}", conv2d(a, b, k, s, dtype=dtype))
            self.add_module(f"{norm}{j}", make_norm(norm, b, dtype=dtype))
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.Sequential(
                conv2d(cin, out, 1, stride, dtype=dtype),
                make_norm(norm, out, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        for j in (1, 2, 3):
            out = apply_norm(getattr(self, f"{self.abbr}{j}"),
                             getattr(self, f"conv{j}")(out))
            if j < 3:
                out = F.relu(out)
        identity = x
        if self.downsample is not None:
            conv, norm = self.downsample
            identity = apply_norm(norm, conv(x))
        return F.relu(out + identity)


# depth: (block, stage sizes)
_ARCH = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


class ResNet(nn.Module):
    """Configurable ResNet (reference resnet.py:303-674) on NCHW input.

    ``depth`` 18 | 34 | 50 | 101 | 152; ``base_channels`` the first
    stage's width; ``out_indices`` the 0-based stages whose outputs are
    returned (one tensor, or a tuple in stage order); ``deep_stem`` the
    V1d stem of three 3×3 convolutions instead of one 7×7 (reference
    ResNetV1d, resnet.py:657-674); ``norm`` 'bn' | 'in' | 'gn' (32
    groups). The stem is followed by a 3×3 stride-2 max pool padded with
    −∞. With ``norm="in"`` every norm is the instance-norm kernel on the
    card."""

    def __init__(self, depth: int = 18, base_channels: int = 64,
                 out_indices: Sequence[int] = (3,), deep_stem: bool = False,
                 norm: str = "bn", dtype: torch.dtype | None = None,
                 in_channels: int = 3):
        super().__init__()
        if depth not in _ARCH:
            raise ValueError(f"depth must be one of {sorted(_ARCH)}, got "
                             f"{depth}")
        kind, stages = _ARCH[depth]
        self.out_indices = tuple(out_indices)
        self.deep_stem = deep_stem
        self.abbr = norm
        base = base_channels
        if deep_stem:
            layers = []
            for cin, cout, s in ((in_channels, base // 2, 2),
                                 (base // 2, base // 2, 1),
                                 (base // 2, base, 1)):
                layers += [conv2d(cin, cout, 3, s, dtype=dtype),
                           make_norm(norm, cout, dtype=dtype),
                           nn.ReLU()]
            self.stem = nn.Sequential(*layers)
        else:
            self.conv1 = conv2d(in_channels, base, 7, 2, dtype=dtype)
            self.add_module(f"{norm}1", make_norm(norm, base, dtype=dtype))
        cin = base
        for si, num_blocks in enumerate(stages):
            features = base * 2 ** si
            blocks = []
            for bi in range(num_blocks):
                stride = 2 if (bi == 0 and si > 0) else 1
                if kind == "basic":
                    blocks.append(BasicBlock(cin, features, stride, norm,
                                             dtype=dtype))
                    cin = features
                else:
                    blocks.append(Bottleneck(cin, features, stride, norm,
                                             dtype=dtype))
                    cin = features * Bottleneck.expansion
            self.add_module(f"layer{si + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor):
        if self.deep_stem:
            x = self.stem(x)
        else:
            x = F.relu(apply_norm(getattr(self, f"{self.abbr}1"),
                                  self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        outs = []
        for si in range(4):
            x = getattr(self, f"layer{si + 1}")(x)
            if si in self.out_indices:
                outs.append(x)
        return outs[0] if len(outs) == 1 else tuple(outs)
