"""Build the hand-written CUDA kernels into one shared library, at first use.

Each ``csrc/*.cu`` has a plain C interface. They are compiled for
``sm_90a`` by ``nvcc`` (one process per source, all started together),
linked into ``scflow_torch/_build/libscflow_kernels-<hash>.so`` and loaded
with ``ctypes``. The hash covers the sources and the flags, so an edited
source builds a new library; an existing one is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("rasterize.cu", "instance_norm.cu")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
                           "kernels are built from source at first use")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; raise with the log of the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], None
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0 and failed is None:
            failed = f"{' '.join(cmd)} failed:\n{out}"
    if failed:
        raise RuntimeError(failed)
    return logs


def build() -> Path:
    """Compile and link the kernels unless this source hash is built."""
    digest = _digest()
    target = BUILD_DIR / f"libscflow_kernels-{digest}.so"
    if target.exists():
        build_info.update(path=str(target), seconds=0.0, cached=True)
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", o]
                         for s, o in zip(SOURCES, objs)])
        lib = os.path.join(tmp, target.name)
        logs += _run_all([[nvcc, "-shared", *ARCH, "-o", lib, *objs]])
        os.replace(lib, target)          # atomic: concurrent builds agree
    log = "\n".join(logs)
    (BUILD_DIR / f"build-{digest}.log").write_text(log)
    build_info.update(path=str(target), seconds=time.perf_counter() - t0,
                      cached=False, log=log)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.scflow_error_string.argtypes = [ctypes.c_int]
        lib.scflow_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def entry(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """C entry ``name`` of the library with its argument types declared;
    every entry returns a ``cudaError_t`` as int."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaError_t``."""
    if err != 0:
        msg = library().scflow_error_string(err)
        raise RuntimeError(f"{name}: CUDA error {err}: {msg.decode()}")
