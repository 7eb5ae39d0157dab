"""Shared helpers for the hand-written CUDA kernels (the counterpart of
``big_linear_algebra_tpu/ops/pallas_utils.py``).

Kernels live in ``big_linear_algebra_tpu_torch/csrc/<name>.cu`` with a plain C
interface. ``load_library(name)`` compiles one with ``nvcc`` for ``sm_90a``
into ``build/torch_kernels/`` at the repository root on first use, keyed by a
hash of the flags, the source and the shared headers ``csrc/*.cuh`` (an
edited source or header rebuilds; an unchanged one loads the cached
library), and loads it with ctypes; ``build(names)`` starts
one nvcc per source at once. nvcc runs with ``-Xptxas -v``, and its output
(each kernel's registers, shared memory and spills) is kept beside the
library for ``build_log(name)``. Nothing is built when a module is imported, so
the CPU tests import every module without a toolchain. ``aligned(x)``
copies an operand that the bf16 kernels cannot read in 16-byte pieces.

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
from typing import Iterable, List, Optional, Tuple

import torch

from big_linear_algebra_tpu_torch.utils import debug, trace

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    """Hash of the flags, the source and every header of ``CSRC`` (sorted by
    name): a source may include any of them, so an edited header rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(src.parent.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    return BUILD_DIR / f"lib{name}_{_source_hash(src)}.so"


def _compile(name: str) -> Tuple[subprocess.Popen, List[str], Path, Path]:
    """Start nvcc on ``csrc/<name>.cu`` into a temporary file; returns
    (process, command, temporary path, library path)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = library_path(name)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, cmd, tmp, so


def build(names: Iterable[str]) -> None:
    """Build every ``csrc/<name>.cu`` of ``names`` that is not built yet,
    one nvcc process per source, all started together; raises if any
    build fails (after all have ended). Under a profiler the builds are
    the span ``bla.kernels.build.<name>[,<name>...]``."""
    with _lock:
        todo = [name for name in names if not library_path(name).is_file()]
        if not todo:
            return
        with trace.span("bla.kernels.build." + ",".join(todo)):
            jobs = [_compile(name) for name in todo]
            errors = []
            for proc, cmd, tmp, so in jobs:
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"building {so.name} failed "
                                  f"({' '.join(cmd)}):\n{out}")
                else:
                    so.with_suffix(".log").write_text(out)
                    # atomic: a concurrent loader sees all or none
                    os.replace(tmp, so)
        if errors:
            raise RuntimeError("\n".join(errors))


def build_log(name: str) -> str:
    """What nvcc printed while building ``csrc/<name>.cu`` (ptxas's
    per-kernel registers, shared memory and spills); builds it if needed."""
    build([name])
    return library_path(name).with_suffix(".log").read_text()


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; raises on failure.
    Once loaded, a library is returned without touching the source."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = ctypes.CDLL(str(library_path(name)))
        lib.bla_cuda_error_string.restype = ctypes.c_char_p
        lib.bla_cuda_error_string.argtypes = [ctypes.c_int]
        _libs[name] = lib
        return lib


def aligned(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a contiguous copy of it where it is not contiguous and
    16-byte aligned: the bf16 kernels copy rows in 16-byte pieces, so a
    view at an odd offset is copied."""
    if x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def check(lib: ctypes.CDLL, rc: int, what: str,
          *outputs: Optional[torch.Tensor]) -> None:
    """Raise if a C entry returned a CUDA error code (``cudaGetLastError()``
    right after its launch). Under ``utils.debug_nans`` / ``no_jit`` the
    launch's ``outputs`` are then checked for NaN and the device
    synchronized, as every ATen op is: no dispatch mode sees a ctypes
    launch."""
    if rc != 0:
        msg = lib.bla_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
    debug.check_launch(what, outputs)
