"""Shared helpers for the hand-written CUDA kernels (the counterpart of
``big_linear_algebra_tpu/ops/pallas_utils.py``).

Kernels live in ``big_linear_algebra_tpu_torch/csrc/<name>.cu`` with a plain C
interface. ``load_library(name)`` compiles one with ``nvcc`` for ``sm_90a``
into ``build/torch_kernels/`` at the repository root on first use, keyed by a
hash of the sources and flags (an edited source rebuilds; an unchanged one
loads the cached library), and loads it with ctypes. Nothing is built when a
module is imported, so the CPU tests import every module without a toolchain.

A build failure raises: there is no fallback to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then
    ``/usr/local/cuda/bin/nvcc``, then ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the CUDA kernels")
    return found


def _source_hash(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.name.encode())
    h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    return BUILD_DIR / f"lib{name}_{_source_hash(src)}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; raises on failure."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = CSRC / f"{name}.cu"
        so = library_path(name)
        if not so.is_file():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {src.name} failed ({' '.join(cmd)}):\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
        lib = ctypes.CDLL(str(so))
        lib.bla_cuda_error_string.restype = ctypes.c_char_p
        lib.bla_cuda_error_string.argtypes = [ctypes.c_int]
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code (``cudaGetLastError()``
    right after its launch)."""
    if rc != 0:
        msg = lib.bla_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
