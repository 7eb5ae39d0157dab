"""The library-wide matmul precision policy, in one place (the PyTorch
counterpart of ``big_linear_algebra_tpu/ops/precision.py``).

bfloat16 operands take the fast path (tensor cores where a kernel uses them,
f32 accumulation always); float32 means true float32. On an NVIDIA GPU
PyTorch may silently run f32 matmuls and convolutions in TF32, which keeps
about three decimal digits — the GPU form of the fault the JAX package guards
against with ``Precision.HIGHEST`` (deep group-norm chains amplified it to
O(1) output error on the TPU). ``apply()`` switches TF32 off for both cuBLAS
and cuDNN; the package calls it at import.
"""

from __future__ import annotations

import torch

# True float32 for every f32 matmul and convolution PyTorch runs for us.
ALLOW_TF32_MATMUL = False
ALLOW_TF32_CUDNN = False


def apply() -> None:
    """Set the policy on PyTorch's global backend flags."""
    torch.backends.cuda.matmul.allow_tf32 = ALLOW_TF32_MATMUL
    torch.backends.cudnn.allow_tf32 = ALLOW_TF32_CUDNN


def accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation type for a product of ``dtype`` operands: f64 stays f64
    (CPU parity mode), everything else accumulates in f32."""
    return torch.float64 if dtype == torch.float64 else torch.float32
