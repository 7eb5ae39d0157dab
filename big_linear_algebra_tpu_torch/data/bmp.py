"""24-bit BMP writer and reader, the counterpart of
``big_linear_algebra_tpu/data/bmp.py`` (≈ write_bmp_data, lib/bmp.c:11);
host numpy, no torch.

As in the JAX package, the info header is a correct BITMAPINFOHEADER (the
reference writes byte 32 twice, SURVEY.md §7.14), and the first input row is
rendered at the *bottom* (BMP convention); callers flip for top-down content
(lib/cifar10.c:19). The native path (``native/bla_io.cc``) and the
pure-Python path write the same bytes.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from big_linear_algebra_tpu_torch.data import _native


def write_bmp(path: str, red: np.ndarray, green: np.ndarray,
              blue: np.ndarray) -> None:
    """Write per-channel uint8 planes of shape (height, width) as a BMP."""
    r = np.ascontiguousarray(red, dtype=np.uint8)
    g = np.ascontiguousarray(green, dtype=np.uint8)
    b = np.ascontiguousarray(blue, dtype=np.uint8)
    if not (r.shape == g.shape == b.shape) or r.ndim != 2:
        raise ValueError(
            f"write_bmp expects three equal (H, W) planes, got "
            f"{r.shape}/{g.shape}/{b.shape}")
    height, width = r.shape
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    if _native.bmp_write(str(path), r, g, b, width, height):
        return
    row_size = ((24 * width + 31) // 32) * 4
    file_size = 54 + row_size * height
    header = struct.pack(
        "<2sIHHIIiiHHIIiiII",
        b"BM", file_size, 0, 0, 54,
        40, width, height, 1, 24, 0, 0, 72, 72, 0, 0,
    )
    rows = np.zeros((height, row_size), dtype=np.uint8)
    rows[:, : 3 * width] = np.stack([b, g, r], axis=-1).reshape(
        height, 3 * width)
    Path(path).write_bytes(header + rows.tobytes())


def read_bmp(path: str):
    """Minimal 24-bit reader → (red, green, blue) planes, row 0 the image's
    bottom row, as ``write_bmp`` stores it."""
    raw = Path(path).read_bytes()
    if raw[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    offset = struct.unpack_from("<I", raw, 10)[0]
    width = struct.unpack_from("<i", raw, 18)[0]
    height = struct.unpack_from("<i", raw, 22)[0]
    bpp = struct.unpack_from("<H", raw, 28)[0]
    if bpp != 24:
        raise ValueError(f"{path}: expected 24-bit BMP, got {bpp}")
    row_size = ((24 * width + 31) // 32) * 4
    rows = np.frombuffer(
        raw, dtype=np.uint8, count=row_size * abs(height), offset=offset
    ).reshape(abs(height), row_size)
    pix = rows[:, : 3 * width].reshape(abs(height), width, 3)
    if height < 0:
        # top-down file (negative biHeight): flip so row 0 is the bottom row
        pix = pix[::-1]
    return pix[..., 2].copy(), pix[..., 1].copy(), pix[..., 0].copy()
