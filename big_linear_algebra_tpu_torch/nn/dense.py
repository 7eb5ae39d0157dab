"""Dense (fully-connected) layer, the counterpart of
``big_linear_algebra_tpu/nn/dense.py``.

Batch-major ``z = act(x @ W + b)`` with ``x``: (batch, in) and ``W``:
(in, out), as in the JAX package. The bias add and the optional ReLU (the
reference's hidden layers, model/mnist_nn.c:224,229) are fused into the GEMM
kernel's epilogue (ops/matmul.py): one launch per layer.

The backward is the JAX package's hand-written ``_dense_bwd`` (the
reference's ``dW = dz @ actᵀ``, ``db = col_sum(dz)``, ``dx = Wᵀ @ dz``,
model/mnist_nn.c:259-293, with the corrected col-sum of SURVEY.md §7.6): the
cotangent masked by ``out > 0`` under ReLU (⇔ pre-activation > 0,
model/mnist_nn.c:273-278), then dx = nt(g, w) and dw = tn(x, g) on K1
without a materialized transpose, and db = g summed over the batch. dx is
computed only when x takes a gradient (the input layer's does not).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from big_linear_algebra_tpu_torch.ops.matmul import _dispatch


class _DenseFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, activation):
        out = _dispatch(x, w, "nn", bias=b, activation=activation)
        ctx.activation = activation
        ctx.save_for_backward(x, w, out if activation == "relu" else None)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        g = g.to(x.dtype)
        if ctx.activation == "relu":
            g = g * (out > 0).to(g.dtype)
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = _dispatch(g, w, "nt", x.dtype) if need_x else None  # g @ wᵀ
        dw = _dispatch(x, g, "tn", w.dtype) if need_w else None  # xᵀ @ g
        db = torch.sum(g, dim=0) if need_b else None  # col-sum over the batch
        return dx, dw, db, None


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          activation: Optional[str] = None) -> torch.Tensor:
    """``act(x @ w + b)``. x: (B, in), w: (in, out), b: (out,);
    ``activation``: None or "relu" (fused into the kernel epilogue)."""
    return _DenseFn.apply(x, w, b, activation)


class Dense(nn.Module):
    """A dense layer holding ``weight`` (in, out) and ``bias`` (out,)."""

    def __init__(self, in_features: int, out_features: int,
                 activation: Optional[str] = None, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.activation = activation
        self.weight = nn.Parameter(
            torch.zeros((in_features, out_features), device=device,
                        dtype=dtype))
        self.bias = nn.Parameter(
            torch.zeros((out_features,), device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.activation)
