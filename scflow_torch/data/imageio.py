"""Image reading without cv2 or PIL: a stdlib PNG decoder and the port's
own JPEG decoder.

The JAX package reads images through its C++ library, cv2 or PIL
(``scflow_tpu/data/bop.py:27-50``); the port's readers use :func:`imread`,
which returns what ``cv2.imread`` returns, RGB-ordered. It dispatches on
the file's signature, not its extension:

- JPEG (``FF D8``) goes to :mod:`.jpeg` (a C++ decoder built at first use,
  bit-equal to cv2's libjpeg-turbo). A gray JPEG read in color repeats Y
  into three channels, a color JPEG read as gray is its Y plane.
- PNG is parsed with ``struct`` and inflated with ``zlib`` (the inverse
  of ``utils.tb_writer.encode_png``); the host library's C++ undoes the
  rows' filters (``csrc/png_unfilter.cpp``, one call per image, the GIL
  released). 8-bit gray, gray+alpha, RGB and RGBA, any filter type, any
  number of IDAT chunks. A color read drops alpha
  and repeats gray into three channels, as cv2's ``IMREAD_COLOR`` does. A
  gray read of a color PNG drops alpha and applies libpng's rgb-to-gray,
  which cv2 uses: ``(9797 R + 19234 G + 3737 B) >> 15``, truncated.

Interlaced, palette and 16-bit PNGs, and the JPEG forms :mod:`.jpeg`
refuses, raise a ``ValueError`` that names the file. :func:`check_readable`
raises the same error from a file's header alone.
"""
from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

from ._build import library
from .jpeg import HeaderIncomplete, decode_jpeg, jpeg_info

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}      # color type → samples per pixel
_JPEG_HEAD = 1 << 16      # bytes check_readable reads before the whole file
# libpng's png_set_rgb_to_gray(…, 0.299, 0.587) in 1/32768 (cv2's gray read)
_PNG_GRAY = (9797, 19234, 3737)


def imread(path: str, gray: bool = False) -> np.ndarray:
    """Read a JPEG or 8-bit PNG: (H, W, 3) RGB uint8, or with ``gray`` the
    (H, W) gray plane. A missing file raises ``FileNotFoundError``,
    anything this reader does not decode ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == JPEG_SIGNATURE:
        return decode_jpeg(data, path, gray)
    pixels, color = decode_png(data, path)
    if gray:
        if color in (0, 4):
            return np.ascontiguousarray(pixels[..., 0])
        acc = np.zeros(pixels.shape[:2], np.uint32)
        for c, weight in enumerate(_PNG_GRAY):
            acc += np.uint32(weight) * pixels[..., c]
        return (acc >> 15).astype(np.uint8)
    if color in (0, 4):
        return np.repeat(pixels[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pixels[..., :3])


def check_readable(path: str) -> None:
    """Raise what :func:`imread` would raise for a file it cannot decode
    (missing, neither PNG nor JPEG, interlaced, palette, 16-bit PNG, a
    JPEG form the decoder refuses), reading only the file's header; and,
    for a JPEG that does not end in EOI (truncated, or data after EOI),
    decoding the file."""
    with open(path, "rb") as f:
        head = f.read(_JPEG_HEAD)
        if head[:2] == JPEG_SIGNATURE:
            _check_jpeg(f, head, path)
            return
    _check_signature(head, path)
    length, kind = struct.unpack(">I4s", head[8:16])
    if kind != b"IHDR" or length != 13:
        raise ValueError(f"{path}: PNG without IHDR first")
    _check_header(struct.unpack(">IIBBBBB", head[16:29]), path)


def _check_jpeg(f, head: bytes, path: str) -> None:
    try:
        jpeg_info(head, path)
    except HeaderIncomplete:
        if len(head) < _JPEG_HEAD:
            raise ValueError(f"{path}: JPEG not decoded: truncated file"
                             ) from None
        jpeg_info(head + f.read(), path)
    f.seek(-2, os.SEEK_END)
    if f.read(2) != b"\xff\xd9":
        f.seek(0)
        decode_jpeg(f.read(), path)


def _check_signature(data: bytes, path: str) -> None:
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def _check_header(header: tuple, path: str) -> None:
    _, _, depth, color, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if color not in _CHANNELS:
        raise ValueError(f"{path}: palette PNG (color type {color}) is not "
                         "supported")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG is not supported "
                         "(8-bit only)")


def decode_png(data: bytes, path: str = "<bytes>") -> tuple[np.ndarray, int]:
    """Decode PNG bytes → ((H, W, C) uint8 samples, PNG color type)."""
    raw, height, width, bpp, color = _inflate_png(data, path)
    out = _unfilter_rows(raw, height, width * bpp, bpp, path)
    return out.reshape(height, width, bpp), color


def _inflate_png(data: bytes, path: str) -> tuple:
    """(inflated rows (uint8, each a filter byte and its samples), height,
    width, bytes per pixel, color type) of a PNG file's bytes."""
    _check_signature(data, path)
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
    _check_header(header, path)
    width, height, _, color = header[:4]
    bpp = _CHANNELS[color]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: PNG data of {raw.size} bytes for "
                         f"{height} rows of {stride}")
    return raw, height, width, bpp, color


def _unfilter_rows(raw: np.ndarray, height: int, stride: int, bpp: int,
                   path: str) -> np.ndarray:
    """(height, stride) samples of the inflated rows ``raw``, every row's
    filter undone by the host library (``csrc/png_unfilter.cpp``)."""
    out = np.empty((height, stride), np.uint8)
    bad_row = ctypes.c_int64()
    kind = library().scflow_png_unfilter(raw.ctypes.data, height, stride, bpp,
                                         out.ctypes.data,
                                         ctypes.byref(bad_row))
    if kind:
        raise ValueError(f"{path}: unknown PNG filter type {kind}")
    return out


def _unfilter_rows_np(raw: np.ndarray, height: int, stride: int, bpp: int,
                      path: str) -> np.ndarray:
    """:func:`_unfilter_rows` row by row in numpy and Python
    (:func:`_unfilter`): the witness of the C++ pass."""
    rows = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        out[y] = _unfilter(int(rows[y, 0]), rows[y, 1:], prev, bpp, path)
        prev = out[y]
    return out


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
