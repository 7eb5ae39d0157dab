"""ctypes binding for the native host-IO library (``native/bla_io.cc``), the
counterpart of ``big_linear_algebra_tpu/data/_native.py``.

The shared object is built on demand with g++ into ``build/native/`` at the
repository root (or ``$BLA_NATIVE_CACHE``) and rebuilt when the source
changes. This is host IO, not a device kernel: every caller handles ``lib()
is None`` (no compiler / no source tree) by taking the pure-Python path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "bla_io.cc"

_lib = None
_tried = False


def lib():
    """Return the loaded native library, building it if needed, else None."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not _SOURCE.is_file():
        return None
    cache = Path(os.environ.get("BLA_NATIVE_CACHE") or _ROOT / "build" / "native")
    try:
        cache.mkdir(parents=True, exist_ok=True)
        so = cache / "libbla_io.so"
        if not so.exists() or so.stat().st_mtime < _SOURCE.stat().st_mtime:
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(
                ["g++", "-O3", "-fPIC", "-Wall", "-std=c++17", "-shared",
                 "-o", str(tmp), str(_SOURCE)],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, so)  # a concurrent process never loads a partial file
        handle = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError):
        return None
    handle.bla_csv_count.restype = ctypes.c_long
    handle.bla_csv_count.argtypes = [ctypes.c_char_p]
    handle.bla_csv_read.restype = ctypes.c_long
    handle.bla_csv_read.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long]
    handle.bla_csv_write.restype = ctypes.c_int
    handle.bla_csv_write.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_long, ctypes.c_long]
    handle.bla_count_lines.restype = ctypes.c_long
    handle.bla_count_lines.argtypes = [ctypes.c_char_p]
    handle.bla_cifar_read.restype = ctypes.c_long
    handle.bla_cifar_read.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
    handle.bla_bmp_write.restype = ctypes.c_int
    handle.bla_bmp_write.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int]
    _lib = handle
    return _lib


def csv_read(path: str) -> np.ndarray | None:
    """Native CSV parse → float32 array, or None if native lib unavailable."""
    handle = lib()
    if handle is None:
        return None
    n = handle.bla_csv_count(path.encode())
    if n < 0:
        raise FileNotFoundError(path)
    out = np.empty(n, dtype=np.float32)
    got = handle.bla_csv_read(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n
    )
    if got != n:  # file changed between the two passes
        raise IOError(f"CSV changed while reading: {path}")
    return out


def csv_write(path: str, data: np.ndarray) -> bool:
    handle = lib()
    if handle is None:
        return False
    arr = np.ascontiguousarray(data, dtype=np.float32)
    rows, cols = (arr.shape if arr.ndim == 2 else (1, arr.size))
    rc = handle.bla_csv_write(
        path.encode(),
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rows, cols,
    )
    if rc != 0:
        raise IOError(f"native CSV write failed: {path}")
    return True


def count_lines(path: str) -> int | None:
    """Native count of newline characters, or None if the native library is
    unavailable."""
    handle = lib()
    if handle is None:
        return None
    n = handle.bla_count_lines(path.encode())
    if n < 0:
        raise FileNotFoundError(path)
    return n


def cifar_read(path: str, max_examples: int = 10000):
    """Native read of a CIFAR-10 binary batch → (labels uint8 (n,), pixels
    uint8 (n, 3072)), or None if the native library is unavailable."""
    handle = lib()
    if handle is None:
        return None
    labels = np.empty(max_examples, dtype=np.uint8)
    pixels = np.empty((max_examples, 3072), dtype=np.uint8)
    n = handle.bla_cifar_read(
        path.encode(),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        pixels.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        max_examples,
    )
    if n < 0:
        raise FileNotFoundError(path)
    return labels[:n].copy(), pixels[:n].copy()


def bmp_write(path: str, red: np.ndarray, green: np.ndarray,
              blue: np.ndarray, width: int, height: int) -> bool:
    """Native 24-bit BMP write of three (height, width) uint8 planes; False
    if the native library is unavailable."""
    handle = lib()
    if handle is None:
        return False
    r = np.ascontiguousarray(red, dtype=np.uint8)
    g = np.ascontiguousarray(green, dtype=np.uint8)
    b = np.ascontiguousarray(blue, dtype=np.uint8)
    rc = handle.bla_bmp_write(
        path.encode(),
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        g.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        width, height,
    )
    if rc != 0:
        raise IOError(f"native BMP write failed: {path}")
    return True
