"""Reference-compatible CSV weight layouts, the counterpart of
``big_linear_algebra_tpu/ckpt/csv_layouts.py``.

Each model module declares its layout as ``{name: (rows, cols)}`` and calls
these. The reference stores dense weights as (out, in); the models are
batch-major with (in, out) weights, so the per-model code transposes and the
on-disk bytes stay reference-compatible (and identical to the JAX package's).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np

from big_linear_algebra_tpu_torch.data.csv import (
    read_csv_matrix,
    write_csv_matrix,
)


def save_matrices(base_dir: str,
                  arrays: Mapping[str, np.ndarray]) -> None:
    """Write each array to ``base_dir/<name>`` in reference CSV format."""
    base = Path(base_dir)
    for name, arr in arrays.items():
        write_csv_matrix(str(base / name), np.asarray(arr))


def load_matrices(base_dir: str,
                  spec: Mapping[str, Tuple[int, int]],
                  dtype=np.float32) -> Dict[str, np.ndarray]:
    """Load ``{name: (rows, cols)}`` CSVs from ``base_dir``."""
    base = Path(base_dir)
    return {
        name: read_csv_matrix(str(base / name), rows, cols, dtype=dtype)
        for name, (rows, cols) in spec.items()
    }


def layout_exists(base_dir: str, spec: Mapping[str, Tuple[int, int]]) -> bool:
    base = Path(base_dir)
    return all((base / name).is_file() for name in spec)
