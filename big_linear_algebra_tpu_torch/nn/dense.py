"""Dense (fully-connected) layer, the counterpart of
``big_linear_algebra_tpu/nn/dense.py``.

Batch-major ``z = act(x @ W + b)`` with ``x``: (batch, in) and ``W``:
(in, out), as in the JAX package. The bias add and the optional ReLU (the
reference's hidden layers, model/mnist_nn.c:224,229) are fused into the GEMM
kernel's epilogue (ops/matmul.py): one launch per layer.

Forward only: the hand-written backward (``_dense_bwd``) comes with training.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from big_linear_algebra_tpu_torch.ops.matmul import _dispatch


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          activation: Optional[str] = None) -> torch.Tensor:
    """``act(x @ w + b)``. x: (B, in), w: (in, out), b: (out,);
    ``activation``: None or "relu" (fused into the kernel epilogue)."""
    return _dispatch(x, w, "nn", bias=b, activation=activation)


class Dense(nn.Module):
    """A dense layer holding ``weight`` (in, out) and ``bias`` (out,).

    The parameters do not require grad: the layer is forward-only until its
    hand-written backward is ported."""

    def __init__(self, in_features: int, out_features: int,
                 activation: Optional[str] = None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.activation = activation
        self.weight = nn.Parameter(
            torch.zeros((in_features, out_features), device=device,
                        dtype=dtype), requires_grad=False)
        self.bias = nn.Parameter(
            torch.zeros((out_features,), device=device, dtype=dtype),
            requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.activation)
