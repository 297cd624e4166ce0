"""Build the host (CPU) C++ library of the data path, at first use.

The sources in ``csrc/`` (the JPEG decoder, PNG unfiltering, the eval
crop, the train crop's and augmentations' pixel passes) have plain C
interfaces and need nothing beyond the C++ standard library. They are
compiled by ``$CXX`` (else ``c++``, else ``g++``) into
``scflow_torch/_build/libscflow_host-<hash>.so`` and loaded with
``ctypes.CDLL``, which releases the GIL for each call, so threads decode,
crop and augment in parallel. The hash covers the sources, the compiler
and the flags: an edited source builds a new library, an existing one is
reused. It is a library apart from the CUDA kernels', so a machine
without ``nvcc`` builds it. A failed build raises with the compiler's
log.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("jpeg_decode.cpp", "png_unfilter.cpp", "crop.cpp", "cvops.cpp")
# The float code (crop, cvops) writes std::fma where its numpy witness
# fuses a multiply-add; -ffp-contract=off keeps the compiler from fusing
# any other, so the bits do not depend on -march. No -ffast-math.
CXX_FLAGS = ("-std=c++17", "-O3", "-ffp-contract=off", "-fPIC", "-shared")

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()
build_info: dict = {}


def _compiler() -> str:
    for name in (os.environ.get("CXX"), "c++", "g++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("no C++ compiler found ($CXX, c++ or g++); the host "
                       "library is built from source at first use")


def _digest(cxx: str) -> str:
    h = hashlib.sha256(" ".join((cxx, *CXX_FLAGS)).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the host library unless this source hash is built."""
    cxx = _compiler()
    target = BUILD_DIR / f"libscflow_host-{_digest(cxx)}.so"
    if target.exists():
        build_info.update(path=str(target), seconds=0.0, cached=True)
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, target.name)
        cmd = [cxx, *CXX_FLAGS, "-o", lib, *(str(CSRC / s) for s in SOURCES)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}")
        os.replace(lib, target)          # atomic: concurrent builds agree
    build_info.update(path=str(target), seconds=time.perf_counter() - t0,
                      cached=False, log=proc.stdout)
    return target


def library() -> ctypes.CDLL:
    """The loaded host library (built on first call), its entries typed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.scflow_jpeg_info.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
                ctypes.c_size_t]
            lib.scflow_jpeg_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                ctypes.c_size_t]
            for fn in (lib.scflow_jpeg_info, lib.scflow_jpeg_decode):
                fn.restype = ctypes.c_int
            _declare(lib)
            _lib = lib
    return _lib


def _declare(lib: ctypes.CDLL) -> None:
    """ctypes signatures of the PNG, crop and cvops entries."""
    ptr, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    entries = {
        "scflow_png_unfilter": (ctypes.c_int, [ptr, i64, i64, ctypes.c_int,
                                               ptr, ctypes.POINTER(i64)]),
        "scflow_crop_resize_pad": (None, [ptr, i64, i64, ptr, ctypes.c_int,
                                          ctypes.c_int, f32, ptr, ptr, ptr,
                                          ptr]),
        "scflow_resize_linear": (None, [ptr, i64, i64, i64, ptr, i64, i64]),
        "scflow_gaussian_blur": (ctypes.c_int, [ptr, i64, i64, i64,
                                                ctypes.c_int, ptr]),
        "scflow_rgb_to_gray": (None, [ptr, i64, ptr]),
        "scflow_rgb_to_hsv": (None, [ptr, i64, ptr]),
        "scflow_hsv_to_rgb": (None, [ptr, i64, i64, ptr]),
        "scflow_hsv_jitter": (None, [ptr, i64, i64, f32, f32, f32, ptr]),
    }
    for name, (restype, argtypes) in entries.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
