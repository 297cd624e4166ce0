"""JPEG decoding without cv2, PIL or libjpeg.

The JAX package decodes JPEG through its C++ library, which links the
system libjpeg (``native/scflow_native.cpp``), or through cv2
(``scflow_tpu/data/bop.py:27-50``). The port has a decoder of its own,
``csrc/jpeg_decode.cpp``, built with the host's C++ compiler at first use
(``_build``). For every file it accepts it returns what ``cv2.imread``
returns, RGB-ordered: libjpeg-turbo's defaults (ISLOW IDCT, fancy
upsampling) for a color read, the Y plane for a gray read. It accepts
Huffman baseline, extended sequential and progressive files at 8 bits
with 1 or 3 components; every refusal is a ``ValueError`` naming the file
(the C++ source lists them).
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np

from ._build import library

PROCESSES = {0: "baseline", 1: "extended sequential", 2: "progressive"}
_ERR_SIZE = 256


class HeaderIncomplete(ValueError):
    """The bytes end before the file's first scan."""


@dataclasses.dataclass(frozen=True)
class JpegInfo:
    width: int
    height: int
    components: int
    precision: int
    process: str


def jpeg_info(head: bytes, path: str = "<bytes>") -> JpegInfo:
    """Read a JPEG's header from ``head``, the file's first bytes up to its
    first scan. Raises the ``ValueError`` the decoder would raise for a
    file it refuses in its header (arithmetic coding, lossless, 12-bit,
    CMYK, an EXIF rotation, ...), and :class:`HeaderIncomplete` when
    ``head`` ends before the first scan."""
    info = (ctypes.c_int32 * 5)()
    err = ctypes.create_string_buffer(_ERR_SIZE)
    rc = library().scflow_jpeg_info(head, len(head), info, err, _ERR_SIZE)
    if rc == 2:
        raise HeaderIncomplete(f"{path}: JPEG header incomplete "
                               f"({err.value.decode()})")
    if rc != 0:
        raise ValueError(f"{path}: JPEG not decoded: {err.value.decode()}")
    width, height, components, precision, process = info
    return JpegInfo(width, height, components, precision, PROCESSES[process])


def decode_jpeg(data: bytes, path: str = "<bytes>",
                gray: bool = False) -> np.ndarray:
    """Decode a JPEG file's bytes: (H, W, 3) RGB uint8, or (H, W) with
    ``gray``, equal to ``cv2.imread`` with ``IMREAD_COLOR`` (channels
    reversed) or ``IMREAD_GRAYSCALE``."""
    try:
        info = jpeg_info(data, path)
    except HeaderIncomplete as e:
        raise ValueError(f"{path}: JPEG not decoded: truncated file") from e
    shape = ((info.height, info.width) if gray
             else (info.height, info.width, 3))
    out = np.empty(shape, np.uint8)
    err = ctypes.create_string_buffer(_ERR_SIZE)
    rc = library().scflow_jpeg_decode(data, len(data), int(gray),
                                      out.ctypes.data, out.nbytes, err,
                                      _ERR_SIZE)
    if rc != 0:
        raise ValueError(f"{path}: JPEG not decoded: {err.value.decode()}")
    return out
