"""Reference-format CSV IO (≈ lib/csv.c), the counterpart of
``big_linear_algebra_tpu/data/csv.py``; host-side numpy, no torch.

Format contract (lib/csv.c:7-16,40-52,59-70; SURVEY.md §7.12):
- reading: a ',' always terminates a value (an empty token is the value 0.0);
  a newline terminates a value only when characters were accumulated; '\\r' is
  ignored. Both the reference's trailing-comma files and standard CSVs (with
  an EOF-terminated last value) are accepted.
- writing: every value is rendered ``%f`` (6 decimals) followed by ',', with a
  newline after every ``cols`` values — byte-identical to the reference
  writer and to the JAX package's.

The native C++ path (native/bla_io.cc via ctypes) handles large files; the
pure-Python path implements the identical contract.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from big_linear_algebra_tpu_torch.data import _native

_TOKEN_RE = re.compile(r"[^,\n]*,|[^,\n]+\n|[^,\n]+$")
# strtof-style numeric prefix, so the Python path parses malformed tokens
# exactly like the native path's strtof (leading numeric prefix, else 0.0)
_FLOAT_PREFIX_RE = re.compile(
    r"^[ \t]*[+-]?(?:inf(?:inity)?|nan|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)",
    re.IGNORECASE)


def _parse_token(tok: str) -> float:
    """strtof semantics (native/bla_io.cc:38): parse the leading numeric
    prefix; non-numeric tokens are 0.0. Tokens longer than 63 chars are
    truncated like the native 64-byte buffer."""
    tok = tok[:63]
    try:
        return float(tok)
    except ValueError:
        m = _FLOAT_PREFIX_RE.match(tok)
        return float(m.group(0)) if m else 0.0


def _py_read_values(path: str) -> np.ndarray:
    text = Path(path).read_text().replace("\r", "")
    values = []
    for m in _TOKEN_RE.finditer(text):
        tok = m.group(0).rstrip(",\n")
        values.append(_parse_token(tok) if tok else 0.0)
    return np.asarray(values, dtype=np.float32)


def read_csv_values(path: str) -> np.ndarray:
    """All CSV values in file order as a flat float32 array.
    ≈ ``read_csv_contents`` (lib/csv.c:18)."""
    out = _native.csv_read(str(path))
    if out is None:
        out = _py_read_values(str(path))
    return out


def read_csv_matrix(path: str, rows: int, cols: int,
                    dtype=np.float32, exact: bool = False) -> np.ndarray:
    """First rows*cols CSV values as a (rows, cols) matrix.
    ≈ ``load_matrix_from_csv`` (lib/util.c:57): extra file content is
    ignored unless ``exact=True``, which also errors when the file holds
    more values than the expected shape."""
    values = read_csv_values(path)
    need = rows * cols
    if values.size < need:
        raise ValueError(
            f"{path}: expected at least {need} values, found {values.size}"
        )
    if exact and values.size != need:
        raise ValueError(
            f"{path}: expected exactly {need} values ({rows}x{cols}), "
            f"found {values.size} — the checkpoint was written by a "
            f"different model configuration")
    return values[:need].reshape(rows, cols).astype(dtype)


def write_csv_matrix(path: str, array: np.ndarray) -> None:
    """Write in the reference format (``%f,`` per value, newline per row).
    ≈ ``write_csv_contents`` (lib/csv.c:59). Values are written float32, the
    reference checkpoint precision (model/mnist_nn.c:344-369)."""
    arr = np.ascontiguousarray(array, dtype=np.float32)
    if arr.ndim == 1:
        arr = arr.reshape(1, -1)
    if arr.ndim != 2:
        raise ValueError(f"write_csv_matrix expects 1-D/2-D, got {array.shape}")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    if _native.csv_write(str(path), arr):
        return
    with open(path, "w") as f:
        for row in arr:
            f.write("".join(f"{v:f}," for v in row) + "\n")


def count_num_lines(path: str) -> int:
    """Count newline characters. ≈ ``count_num_lines`` (lib/csv.c:72)."""
    n = _native.count_lines(str(path))
    if n is None:
        n = Path(path).read_bytes().count(b"\n")
    return n
