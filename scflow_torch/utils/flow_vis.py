"""Optical-flow → RGB visualization (copy of ``scflow_tpu/utils/flow_vis.py``:
the mmcv.flow2rgb replacement used by the reference's tensorboard image
logging, base_refiner.py:297-321). numpy only."""
from __future__ import annotations

import numpy as np


def _make_color_wheel() -> np.ndarray:
    """Standard Middlebury 55-color wheel."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((ry + yg + gc + cb + bm + mr, 3))
    col = 0
    wheel[:ry, 0] = 255
    wheel[:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col:col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col:col + yg, 1] = 255
    col += yg
    wheel[col:col + gc, 1] = 255
    wheel[col:col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col:col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col:col + cb, 2] = 255
    col += cb
    wheel[col:col + bm, 2] = 255
    wheel[col:col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col:col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col:col + mr, 0] = 255
    return wheel / 255.0


_WHEEL = _make_color_wheel()


def flow_to_rgb(flow: np.ndarray, unknown_thr: float = 399.0) -> np.ndarray:
    """(H, W, 2) flow → (H, W, 3) float RGB in [0, 1]; pixels with magnitude
    above ``unknown_thr`` (invalid sentinel) render black."""
    flow = np.asarray(flow, np.float64)
    u, v = flow[..., 0], flow[..., 1]
    mag = np.sqrt(u * u + v * v)
    unknown = (mag > unknown_thr) | ~np.isfinite(mag)
    u = np.where(unknown, 0, u)
    v = np.where(unknown, 0, v)
    mag = np.where(unknown, 0, mag)

    max_mag = mag.max() if mag.max() > 0 else 1.0
    u, v = u / max_mag, v / max_mag
    mag = mag / max_mag

    n = len(_WHEEL)
    angle = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (angle + 1) / 2 * (n - 1)
    k0 = np.floor(fk).astype(int) % n
    k1 = (k0 + 1) % n
    f = fk - np.floor(fk)
    col = (1 - f)[..., None] * _WHEEL[k0] + f[..., None] * _WHEEL[k1]
    # saturate toward white at low magnitude
    col = 1 - mag[..., None] * (1 - col)
    col[unknown] = 0.0
    return col.astype(np.float32)
