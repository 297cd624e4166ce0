"""Build the host (CPU) C++ library of the data path, at first use.

``csrc/jpeg_decode.cpp`` has a plain C interface and needs nothing beyond
the C++ standard library. It is compiled by ``$CXX`` (else ``c++``, else
``g++``) into ``scflow_torch/_build/libscflow_host-<hash>.so`` and loaded
with ``ctypes.CDLL``, which releases the GIL for each call, so threads
decode in parallel. The hash covers the sources, the compiler and the
flags: an edited source builds a new library, an existing one is reused.
It is a library apart from the CUDA kernels', so a machine without
``nvcc`` builds it. A failed build raises with the compiler's log.
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
SOURCES = ("jpeg_decode.cpp",)
# integer code only: -O2 with any -march gives the same bits; no -ffast-math
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared")

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
            _lib = lib
    return _lib
