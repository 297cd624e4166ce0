"""Minimal TensorBoard event-file writer (no tensorflow dependency), ported
from ``scflow_tpu/utils/tb_writer.py`` with its own PNG encoder.

Drop-in for the reference's TensorBoard output contract
(models/utils/tensorboard_hook.py:87-120 — ``TensorboardLoggerHook`` scalar
curves + ``TensorboardImgLoggerHook`` image panels): scalars and images are
written as standard ``events.out.tfevents.*`` files that any TensorBoard
install can read. The TFRecord framing (length + masked CRC32C) and the
Event/Summary protobuf wire format are encoded by hand — ~120 lines instead
of a tensorflow import on the training hot path.

Wire format references (stable public formats):
- TFRecord: [uint64 len][uint32 masked_crc(len)][data][uint32 masked_crc(data)]
  with masked_crc(x) = rotr15(crc32c(x)) + 0xa282ead8.
- Event proto: 1=wall_time(double) 2=step(int64) 3=file_version(string)
  5=summary(Summary).
- Summary: repeated 1=Value{1=tag(string) 2=simple_value(float)
  4=image(Image{1=height 2=width 3=colorspace 4=encoded_image_string})}.
- PNG (ISO/IEC 15948): signature, IHDR, one IDAT holding the zlib stream of
  the rows (each prefixed by filter type 0), IEND; each chunk framed as
  [uint32 BE len][type][data][uint32 BE crc32(type + data)]. Encoded with
  stdlib ``zlib`` and ``struct``, so neither cv2 nor PIL is needed.
"""
from __future__ import annotations

import os
import socket
import struct
import time
import zlib

# -- CRC32C (Castagnoli), table-driven --------------------------------------
_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        tbl = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tbl.append(c)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tbl = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- protobuf wire encoding ---------------------------------------------------
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _double_field(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float_field(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _varint_field(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _event(step: int | None = None, wall_time: float | None = None,
           file_version: str | None = None,
           summary_values: bytes = b"") -> bytes:
    msg = _double_field(1, time.time() if wall_time is None else wall_time)
    if step is not None:
        msg += _varint_field(2, step)
    if file_version is not None:
        msg += _bytes_field(3, file_version.encode())
    if summary_values:
        msg += _bytes_field(5, summary_values)
    return msg


class TBEventWriter:
    """Append-only TensorBoard event file in ``logdir``.

    Scalar curves via :meth:`add_scalar`/:meth:`add_scalars`; HWC uint8
    image panels via :meth:`add_image` (PNG-encoded host-side by
    :func:`encode_png`).
    """

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}{filename_suffix}")
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._write(_event(file_version="brain.Event:2"))

    def _write(self, event_bytes: bytes):
        header = struct.pack("<Q", len(event_bytes))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(event_bytes)
        self._f.write(struct.pack("<I", _masked_crc(event_bytes)))

    def add_scalar(self, tag: str, value: float, step: int):
        val = _bytes_field(1, tag.encode()) + _float_field(2, float(value))
        self._write(_event(step=step, summary_values=_bytes_field(1, val)))

    def add_scalars(self, scalars: dict, step: int):
        vals = b"".join(
            _bytes_field(1, _bytes_field(1, tag.encode())
                         + _float_field(2, float(v)))
            for tag, v in scalars.items())
        self._write(_event(step=step, summary_values=vals))

    def add_image(self, tag: str, image, step: int):
        """image: (H, W, 3) or (H, W) uint8 array; PNG-encoded on host."""
        import numpy as np

        img = np.asarray(image)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        h, w, c = img.shape
        png = encode_png(img)
        image_msg = (_varint_field(1, h) + _varint_field(2, w)
                     + _varint_field(3, c) + _bytes_field(4, png))
        val = _bytes_field(1, tag.encode()) + _bytes_field(4, image_msg)
        self._write(_event(step=step, summary_values=_bytes_field(1, val)))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


_PNG_COLOR_TYPE = {1: 0, 3: 2, 4: 6}      # channels → gray, RGB, RGBA


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def encode_png(img) -> bytes:
    """(H, W), (H, W, 1), (H, W, 3) or (H, W, 4) uint8 array → the bytes of
    an 8-bit gray, RGB or RGBA PNG of the same pixels."""
    import numpy as np

    a = np.asarray(img)
    if a.ndim == 2:
        a = a[..., None]
    if (a.dtype != np.uint8 or a.ndim != 3
            or a.shape[-1] not in _PNG_COLOR_TYPE):
        raise ValueError(f"encode_png: need (H, W[, 1|3|4]) uint8, got "
                         f"{a.dtype} {a.shape}")
    h, w, c = a.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)],
                          axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _png_chunk(b"IEND", b""))
