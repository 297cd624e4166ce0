"""Image reading without cv2 or PIL: a stdlib PNG decoder.

The JAX package reads images through its C++ library, cv2 or PIL
(``scflow_tpu/data/bop.py:27-50``); the port's readers use :func:`imread`,
which decodes PNG with ``zlib`` and ``struct`` alone (the inverse of
``utils.tb_writer.encode_png``) and returns what ``cv2.imread`` returns,
RGB-ordered: 8-bit gray, gray+alpha, RGB and RGBA images, any filter
type, any number of IDAT chunks. Alpha is dropped and gray is repeated
into three channels for a color read, as cv2's ``IMREAD_COLOR`` does.

Interlaced, palette and 16-bit PNGs, and JPEG files, raise a
``ValueError`` that names the file: YCB-V's ``test`` and ``train_real``
splits are 8-bit PNG, and JPEG (BOP ``train_pbr``) comes with the
training-data slice.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}      # color type → samples per pixel


def imread(path: str, gray: bool = False) -> np.ndarray:
    """Read an 8-bit PNG: (H, W, 3) RGB uint8, or with ``gray`` the (H, W)
    gray plane of a gray(+alpha) image. A missing file raises
    ``FileNotFoundError``, anything this decoder does not read (JPEG,
    interlaced, palette, 16-bit, a color image read as gray)
    ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    pixels, color = decode_png(data, path)
    if gray:
        if color not in (0, 4):
            raise ValueError(f"{path}: a color PNG read as gray "
                             "(only gray PNGs are read as gray)")
        return np.ascontiguousarray(pixels[..., 0])
    if color in (0, 4):
        return np.repeat(pixels[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pixels[..., :3])


def decode_png(data: bytes, path: str = "<bytes>") -> tuple[np.ndarray, int]:
    """Decode PNG bytes → ((H, W, C) uint8 samples, PNG color type)."""
    if data[:2] == b"\xff\xd8":
        raise ValueError(f"{path}: JPEG is not decoded without cv2 "
                         "(only PNG is)")
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length                      # length, type, body, CRC
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, color, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if color not in _CHANNELS:
        raise ValueError(f"{path}: palette PNG (color type {color}) is not "
                         "supported")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG is not supported "
                         "(8-bit only)")
    bpp = _CHANNELS[color]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: PNG data of {raw.size} bytes for "
                         f"{height} rows of {stride}")
    rows = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        out[y] = _unfilter(int(rows[y, 0]), rows[y, 1:], prev, bpp, path)
        prev = out[y]
    return out.reshape(height, width, bpp), color


def _unfilter(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int,
              path: str) -> np.ndarray:
    """Undo one row's filter (ISO/IEC 15948 §9); uint8 sums wrap mod 256.
    None, Sub and Up are vectorised; Average and Paeth depend on the
    pixel to the left, so they loop over the row's bytes."""
    if kind == 0:
        return line
    if kind == 1:                               # Sub: running sum per sample
        return np.cumsum(line.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).ravel()
    if kind == 2:                               # Up
        return line + prev
    if kind not in (3, 4):
        raise ValueError(f"{path}: unknown PNG filter type {kind}")
    cur = line.tolist()
    up = prev.tolist()
    if kind == 3:                               # Average
        for i in range(len(cur)):
            left = cur[i - bpp] if i >= bpp else 0
            cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
    else:                                       # Paeth
        for i in range(len(cur)):
            if i >= bpp:
                a, c = cur[i - bpp], up[i - bpp]
            else:
                a = c = 0
            b = up[i]
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[i] = (cur[i] + pred) & 0xFF
    return np.asarray(cur, np.uint8)
