"""The pose graph's fixed pixel draw without JAX.

``scflow_tpu``'s ``pose_graph_from_flow`` subsamples each object's valid
pixels by the top ``max_points`` of ``jax.random.gumbel(PRNGKey(0),
(n, h·w))`` (``scflow_tpu/parallel/pose_graph.py:255-258``). That draw
is JAX's threefry-2x32 counter hash (``jax_threefry_partitionable``, the
default): element i of the flat shape hashes the counter pair (hi word of
i, lo word of i) under the key (0, 0), and its 32 random bits are the XOR
of the two output words. :func:`draw_bits` computes them in numpy.

The Gumbel values themselves are not recomputed (numpy's and XLA's ``log``
differ in the last bit): ``jax.random.uniform(tiny, 1)`` maps the 23-bit
mantissa draw ``bits >> 9`` strictly monotonically to u, and −log(−log u)
is strictly monotone in u (checked over all 2^23 draws with XLA), so
ranking by the mantissa ranks by the Gumbel value. :func:`pick_points`
ranks invalid pixels below every valid one and breaks ties toward the
lower index, as ``lax.top_k`` does.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..geometry.pnp import top_k_indices

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: tuple[int, int], x0: np.ndarray,
                 x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011, as JAX computes
    it) of the uint32 counter words ``x0``, ``x1`` under ``key``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def draw_bits(shape: tuple[int, ...], key: tuple[int, int] = (0, 0)) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)`` for a raw threefry key
    (``PRNGKey(0)`` is (0, 0)), bit for bit, as a uint32 array."""
    i = np.arange(int(np.prod(shape)), dtype=np.uint64)
    hi = (i >> np.uint64(32)).astype(np.uint32)
    lo = (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    y0, y1 = threefry2x32(key, hi, lo)
    return (y0 ^ y1).reshape(shape)


@functools.lru_cache(maxsize=8)
def key_table(n: int, hw: int, device: torch.device) -> torch.Tensor:
    """(n, hw) int32 ranks of ``gumbel(PRNGKey(0), (n, hw))``: the 23-bit
    mantissa draws, made on the host and moved to ``device`` once per
    shape (4 MB at 16 × 256²), through pinned memory without waiting for
    the device."""
    keys = torch.from_numpy(
        (draw_bits((n, hw)) >> np.uint32(9)).astype(np.int32))
    if device.type == "cuda":
        return keys.pin_memory().to(device, non_blocking=True)
    return keys


def pick_points(valid: torch.Tensor, max_points: int) -> torch.Tensor:
    """Indices (..., n, max_points) of the pixels ``pose_graph_from_flow``
    keeps: per row of the (..., n, hw) 0/1 mask ``valid``, the valid pixels
    of the largest Gumbel draws first, then invalid pixels by index."""
    n, hw = valid.shape[-2:]
    keys = key_table(n, hw, valid.device)
    scores = torch.where(valid > 0, keys, -1)
    return top_k_indices(scores, max_points)
