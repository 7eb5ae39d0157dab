"""The reference matrix-core surface (``lib/matrix.h:7-32``) as functional
ops, the counterpart of ``big_linear_algebra_tpu/ops/matrix.py``.

Elementwise, reduction and broadcast ops over ``torch.Tensor``, any dtype.
They are plain torch ops and hold no kernel: the GEMM is ``ops/matmul.py``.

Intended-semantics policy (SURVEY.md §7): where the reference has an indexing
bug the evident intent is implemented and the deviation documented — see
``matrix_col_sum``.

Reference mapping:
- ``make_matrix``/``clone_matrix``/``free_matrix`` (lib/matrix.c:6,14,~) —
  not needed: tensors are allocated and freed by torch.
- ``print_matrix``/``print_matrix_dim`` (lib/matrix.c:71,91) —
  ``print_matrix`` below.
"""

from __future__ import annotations

import torch


def matrix_scale(m: torch.Tensor, scalar) -> torch.Tensor:
    """Elementwise scale. ≈ ``matrix_scale`` (lib/matrix.c:59)."""
    return m * torch.as_tensor(scalar, dtype=m.dtype, device=m.device)


def matrix_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise add with exact-shape check. ≈ ``matrix_add``
    (lib/matrix.c:65). The reference exits on any shape mismatch;
    broadcasting is rejected here too (the tile-add ops broadcast a bias)."""
    if a.shape != b.shape:
        raise ValueError(f"matrix_add: shape mismatch {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    return a + b


def matrix_multiply_elementwise(a: torch.Tensor,
                                b: torch.Tensor) -> torch.Tensor:
    """Hadamard product. ≈ ``matrix_multiply_elementwise``
    (lib/matrix.c:95)."""
    if a.shape != b.shape:
        raise ValueError(f"matrix_multiply_elementwise: shape mismatch "
                         f"{tuple(a.shape)} vs {tuple(b.shape)}")
    return a * b


def matrix_transpose(m: torch.Tensor) -> torch.Tensor:
    """Transpose. ≈ ``matrix_transpose`` (lib/matrix.c:105), which clones
    the whole matrix; here a view. Prefer ``matmul_nt``/``matmul_tn`` over
    transpose-then-matmul."""
    return m.T


def matrix_row_sum(m: torch.Tensor) -> torch.Tensor:
    """Sum *along* the rows (values in the same column) → (1, cols).
    ≈ ``matrix_row_sum`` (lib/matrix.c:123)."""
    return torch.sum(m, dim=0, keepdim=True)


def matrix_col_sum(m: torch.Tensor) -> torch.Tensor:
    """Sum *along* the columns (values in the same row) → (rows, 1).

    ≈ the *intent* of ``matrix_col_sum`` (lib/matrix.c:138). The reference
    indexes ``data[i * rows + j]`` instead of ``i * cols + j``
    (lib/matrix.c:144), which is only right for square matrices (SURVEY.md
    §7.6); the correct per-row sum is implemented."""
    return torch.sum(m, dim=1, keepdim=True)


def frobenius_norm(m: torch.Tensor) -> torch.Tensor:
    """Frobenius norm. ≈ ``frobenius_norm`` (lib/matrix.c:150)."""
    return torch.sqrt(torch.sum(m * m))


def max_value(m: torch.Tensor) -> torch.Tensor:
    """Maximum element. ≈ ``max_value`` (lib/matrix.c:160)."""
    return torch.max(m)


def matrix_z_score_normalize(m: torch.Tensor) -> torch.Tensor:
    """Whole-matrix z-score normalization: (m - mean) / std over all entries.

    ≈ ``matrix_z_score_normalize`` (lib/matrix.c:170). The reference takes a
    population std through ``sqrtf`` on doubles (lib/matrix.c:179, SURVEY.md
    §7.14); this takes a full-precision sqrt (intended semantics)."""
    mean = torch.mean(m)
    var = torch.mean((m - mean) ** 2)
    return (m - mean) / torch.sqrt(var)


def matrix_add_tile_columns(m: torch.Tensor,
                            col: torch.Tensor) -> torch.Tensor:
    """Add a (rows, 1) column vector to every column of ``m``.
    ≈ ``matrix_add_tile_columns`` (lib/matrix.c:189), the bias broadcast of
    model/mnist_nn.c:222-233."""
    if tuple(col.shape) != (m.shape[0], 1):
        raise ValueError(f"matrix_add_tile_columns: expected "
                         f"{(m.shape[0], 1)}, got {tuple(col.shape)}")
    return m + col


def matrix_add_tile_rows(m: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """Add a (1, cols) row vector to every row of ``m``.
    ≈ ``matrix_add_tile_rows`` (lib/matrix.c:199), the attention output bias
    of model/cifar_unet.c:1020."""
    if tuple(row.shape) != (1, m.shape[1]):
        raise ValueError(f"matrix_add_tile_rows: expected "
                         f"{(1, m.shape[1])}, got {tuple(row.shape)}")
    return m + row


def print_matrix(m: torch.Tensor, name: str = "") -> None:
    """Host-side debug print. ≈ ``print_matrix`` (lib/matrix.c:71)."""
    arr = m.detach().cpu().double().numpy()  # exact for every float dtype
    if name:
        print(f"{name} ({arr.shape[0]}x"
              f"{arr.shape[1] if arr.ndim > 1 else 1}):")
    for row in arr.reshape(arr.shape[0], -1):
        print(" ".join(f"{v: .6f}" for v in row))
