"""The OpenCV calls that the training-data path makes, without OpenCV.

The JAX package's crop and color augmentations call cv2
(``scflow_tpu/data/pipeline.py:162-173``, ``data/color_aug.py``); the
machine that runs the port has neither cv2 nor PIL. Each function here
names the cv2 call it stands for and follows OpenCV's fixed-point or
float32 arithmetic for uint8 images, so that the port's crops and
augmentations match the JAX package's pixel for pixel, and draw the same
random numbers (a mask pixel that flips would change how many values an
occluder draws). The tests hold each one to cv2.

The resize, blur and color conversions, and :func:`hsv_jitter` (RandomHSV's
pixel pass), run in the host library's C++ (``csrc/cvops.cpp``, built by
``_build``; ctypes releases the GIL). Their numpy forms, the ``_np``
functions below, are the witnesses the tests hold the C++ to, bit for bit;
only tests and chip_smoke's checks call them. ``warp_affine`` is numpy.
"""
from __future__ import annotations

import numpy as np

from ._build import library

_RESIZE_BITS = 11                 # INTER_RESIZE_COEF_BITS
_HSV_SHIFT = 12
_HSV_STEP = 32                    # pixels a vector step of cv2's HSV→RGB


def _channels(img: np.ndarray) -> np.ndarray:
    return img if img.ndim == 3 else img[..., None]


def _resize_taps(n_out: int, n_in: int, clamp_weight: bool):
    """Source taps and 11-bit weights of cv2's bilinear resize along one
    axis: tap positions ``(float)((d + 0.5)·scale − 0.5)`` in float32.
    Horizontally a tap outside the image moves to the edge with weight
    (1, 0); vertically only the row index is clamped."""
    scale = 1.0 / (n_out / n_in)                  # cv2: 1 / inv_scale
    pos = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale
           - 0.5).astype(np.float32)
    i0 = np.floor(pos).astype(np.int64)
    frac = pos - i0.astype(np.float32)
    if clamp_weight:
        low = i0 < 0
        frac[low], i0[low] = 0, 0
        high = i0 >= n_in - 1
        frac[high], i0[high] = 0, n_in - 1
    one = np.float32(1 << _RESIZE_BITS)
    w1 = np.rint(frac * one).astype(np.int64)
    w0 = np.rint((np.float32(1) - frac) * one).astype(np.int64)
    return (np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), w0, w1)


def _resize_linear_np(img: np.ndarray, out_hw) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` for a
    uint8 image (H, W) or (H, W, C): 11-bit weights, an integer
    horizontal pass, and the vectorised vertical pass
    ``((b0·(r0 >> 4)) >> 16) + ((b1·(r1 >> 4)) >> 16) + 2) >> 2`` that
    cv2's SIMD build runs (an exact 2× reduction, which cv2 sends to its
    area path, gives the same values)."""
    oh, ow = (int(v) for v in out_hw)
    h, w = img.shape[:2]
    src = _channels(img).astype(np.int64)
    xa, xb, wa, wb = _resize_taps(ow, w, clamp_weight=True)
    ya, yb, va, vb = _resize_taps(oh, h, clamp_weight=False)
    rows = src[:, xa] * wa[None, :, None] + src[:, xb] * wb[None, :, None]
    va, vb = va[:, None, None], vb[:, None, None]
    out = (((va * (rows[ya] >> 4)) >> 16) + ((vb * (rows[yb] >> 4)) >> 16)
           + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape(
        (oh, ow) + img.shape[2:])


_BLUR_TAPS = {3: (1, 2, 1), 5: (1, 4, 6, 4, 1)}


def _gaussian_blur_np(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), 0)`` for a uint8 image, k ∈ {3, 5}:
    cv2's bit-exact integer kernels (1, 2, 1) and (1, 4, 6, 4, 1) in both
    directions, the border reflected without repeating the edge
    (BORDER_REFLECT_101), the sum rounded half up."""
    taps = _BLUR_TAPS[k]
    r = k // 2
    src = _channels(img).astype(np.int64)
    src = np.pad(src, ((r, r), (r, r), (0, 0)), mode="reflect")
    h, w = img.shape[:2]
    rows = sum(t * src[:, i:i + w] for i, t in enumerate(taps))
    acc = sum(t * rows[i:i + h] for i, t in enumerate(taps))
    total = sum(taps) ** 2
    return ((acc + total // 2) // total).astype(np.uint8).reshape(img.shape)


def _rgb_to_gray_np(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` for uint8 RGB: the 15-bit
    weights of its vectorised path, rounded half up."""
    px = img.astype(np.int64)
    return ((9798 * px[..., 0] + 19235 * px[..., 1] + 3735 * px[..., 2]
             + (1 << 14)) >> 15).astype(np.uint8)


def _hsv_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


_SDIV, _HDIV180 = _hsv_tables()


def _rgb_to_hsv_np(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` for uint8 RGB: H in
    [0, 180], cv2's integer division tables with 12 fractional bits."""
    px = img.astype(np.int64)
    r, g, b = px[..., 0], px[..., 1], px[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = (diff * _SDIV[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a·b + c`` rounded once (a fused multiply-add: the f32
    product is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _hsv_to_rgb_np(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2RGB)`` for uint8 HSV (H in
    [0, 180)): cv2's float32 sector formula, whose two ``1 − s·x`` terms
    are fused multiply-adds, scaled by 255. cv2 converts each row (the
    second last axis) ``_HSV_STEP`` pixels a vector step, which truncates,
    and the row's last ``width % _HSV_STEP`` pixels in scalar code, which
    rounds half to even."""
    f32 = np.float32
    h = img[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = img[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = img[..., 2].astype(f32) * f32(1.0 / 255.0)
    sector = np.trunc(h)
    h = h - sector
    one = f32(1.0)
    tab = np.stack([v, v * (one - s), v * _fma(-s, h, one),
                    v * _fma(-s, one - h, one)], axis=-1)
    # (r, g, b) columns of tab per sector: cv2's sector_data, RGB order
    order = np.array([[0, 3, 1], [2, 0, 1], [1, 0, 3], [1, 2, 0], [3, 1, 0],
                      [0, 1, 2]])
    rgb = np.take_along_axis(tab, order[sector.astype(np.int64) % 6], axis=-1)
    width = _row_width(img)
    x = (rgb * f32(255.0)).reshape(-1, width, 3)
    tail = np.arange(width) >= width // _HSV_STEP * _HSV_STEP
    x = np.where(tail[:, None], np.rint(x), np.trunc(x))
    return np.clip(x, 0, 255).astype(np.uint8).reshape(img.shape)


def _row_width(img: np.ndarray) -> int:
    """Pixels a row of (..., W, 3) pixels (1 for a single pixel)."""
    return img.shape[-2] if img.ndim > 1 and img.shape[-2] else 1


def _hsv_jitter_np(img: np.ndarray, dh: float, ds: float,
                   dv: float) -> np.ndarray:
    """RandomHSV's pixel pass (``scflow_tpu/data/color_aug.py:20-29``)
    given its draws: HSV in float32; H ← (H + dh) % 180, numpy's float32
    remainder (the sign of the divisor; a tiny negative sum rounds up to
    180); S, V scaled and clipped to [0, 255]; truncated to uint8; RGB."""
    f32 = np.float32
    hsv = _rgb_to_hsv_np(img).astype(f32)
    hsv[..., 0] = (hsv[..., 0] + f32(dh)) % f32(180)
    hsv[..., 1] = np.clip(hsv[..., 1] * f32(ds), 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] * f32(dv), 0, 255)
    return _hsv_to_rgb_np(hsv.astype(np.uint8))


# -- the C++ entries (csrc/cvops.cpp) --------------------------------------

def _u8(img: np.ndarray, what: str, rgb: bool = False) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"{what}: uint8 image expected, got {img.dtype}")
    if rgb and (img.ndim < 1 or img.shape[-1] != 3):
        raise ValueError(f"{what}: (..., 3) pixels expected, got "
                         f"{img.shape}")
    if not rgb and (img.ndim not in (2, 3) or 0 in img.shape):
        raise ValueError(f"{what}: (H, W) or (H, W, C) image expected, got "
                         f"{img.shape}")
    return img


def _plane(img: np.ndarray) -> tuple[int, int, int]:
    return img.shape[0], img.shape[1], (img.shape[2] if img.ndim == 3 else 1)


def resize_linear(img: np.ndarray, out_hw) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` for a
    uint8 image (H, W) or (H, W, C); see :func:`_resize_linear_np`."""
    oh, ow = (int(v) for v in out_hw)
    img = _u8(img, "resize_linear")
    if oh < 1 or ow < 1:
        raise ValueError(f"resize_linear: output size {(oh, ow)}")
    out = np.empty((oh, ow) + img.shape[2:], np.uint8)
    library().scflow_resize_linear(img.ctypes.data, *_plane(img),
                                   out.ctypes.data, oh, ow)
    return out


def gaussian_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), 0)`` for a uint8 image, k ∈ {3, 5};
    see :func:`_gaussian_blur_np`."""
    img = _u8(img, "gaussian_blur")
    out = np.empty_like(img)
    if library().scflow_gaussian_blur(img.ctypes.data, *_plane(img), int(k),
                                      out.ctypes.data):
        raise ValueError(f"gaussian_blur: kernel size {k} (3 or 5)")
    return out


def _pixels(entry: str, img: np.ndarray, *args) -> np.ndarray:
    """One of the per-pixel entries on (..., 3) uint8 pixels."""
    img = _u8(img, entry, rgb=True)
    out = np.empty(img.shape[:-1] if entry == "rgb_to_gray" else img.shape,
                   np.uint8)
    getattr(library(), f"scflow_{entry}")(img.ctypes.data, img.size // 3,
                                          *args, out.ctypes.data)
    return out


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` for uint8 RGB; see
    :func:`_rgb_to_gray_np`."""
    return _pixels("rgb_to_gray", img)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` for uint8 RGB (H in
    [0, 180]); see :func:`_rgb_to_hsv_np`."""
    return _pixels("rgb_to_hsv", img)


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_HSV2RGB)`` for uint8 HSV; see
    :func:`_hsv_to_rgb_np`."""
    return _pixels("hsv_to_rgb", img, _row_width(img))


def hsv_jitter(img: np.ndarray, dh: float, ds: float, dv: float) -> np.ndarray:
    """RandomHSV's pixel pass on uint8 RGB, fused: RGB → HSV, the hue shift
    ``dh`` and the scalings ``ds``, ``dv`` (each taken as float32), HSV →
    RGB; see :func:`_hsv_jitter_np`."""
    return _pixels("hsv_jitter", img, _row_width(img), dh, ds, dv)


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: (2, 3) float64;
    the center is taken as float32 (cv2's ``Point2f``)."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


# pixels per vector step of cv2's AVX2 warp kernels (two float32 vectors)
_WARP_LANES = 16


def warp_affine(img: np.ndarray, m: np.ndarray, out_wh,
                nearest: bool = False) -> np.ndarray:
    """``cv2.warpAffine(img, m, (w, h), flags=INTER_LINEAR or
    INTER_NEAREST, borderValue=0)`` for uint8, as OpenCV's vectorised
    float32 kernels compute it: the inverse map in float64 rounded to
    float32; per row ``y·M1 + M2`` in float32, per pixel ``fma(M0, x, ·)``
    (the columns of the scalar tail otherwise); nearest rounds the source
    position half to even, bilinear blends the four taps with fused
    multiply-adds (taps outside the image read 0) and rounds half to
    even."""
    f32 = np.float32
    ow, oh = (int(v) for v in out_wh)
    m = np.asarray(m, np.float64).reshape(2, 3)
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    inv = np.array([a11, a12, -a11 * m[0, 2] - a12 * m[1, 2],
                    a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]).astype(f32)
    x = np.arange(ow, dtype=f32)[None, :]
    y = np.arange(oh, dtype=f32)[:, None]
    sx = _fma(inv[0], x, y * inv[1] + inv[2])
    sy = _fma(inv[3], x, y * inv[4] + inv[5])
    # the columns after the last whole vector step run cv2's scalar
    # loop: fma(x, M0, y·M1) + M2
    tail = ow // _WARP_LANES * _WARP_LANES
    xt = x[:, tail:]
    sx[:, tail:] = _fma(xt, inv[0], y * inv[1]) + inv[2]
    sy[:, tail:] = _fma(xt, inv[3], y * inv[4]) + inv[5]
    h, w = img.shape[:2]
    src = _channels(img)
    if nearest:
        xi, yi = np.rint(sx).astype(np.int64), np.rint(sy).astype(np.int64)
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        out = src[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
        out = np.where(inside[..., None], out, 0)
        return out.astype(img.dtype).reshape((oh, ow) + img.shape[2:])
    x0, y0 = np.floor(sx), np.floor(sy)
    ax, ay = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    # taps outside the image read 0: index a frame padded by one pixel
    pad = np.zeros((h + 2, w + 2, src.shape[2]), f32)
    pad[1:-1, 1:-1] = src
    xa, xb = np.clip(x0, -1, w) + 1, np.clip(x0 + 1, -1, w) + 1
    ya, yb = np.clip(y0, -1, h) + 1, np.clip(y0 + 1, -1, h) + 1
    top = _fma(ax, pad[ya, xb] - pad[ya, xa], pad[ya, xa])
    bottom = _fma(ax, pad[yb, xb] - pad[yb, xa], pad[yb, xa])
    out = _fma(ay, bottom - top, top)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8).reshape(
        (oh, ow) + img.shape[2:])
