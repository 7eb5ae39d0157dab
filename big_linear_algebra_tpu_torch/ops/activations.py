"""Activations, the counterpart of ``big_linear_algebra_tpu/ops/activations.py``
(≈ reference ``lib/util.c``).

- ``relu``              ≈ ``relu``             (lib/util.c:7)
- ``softmax``           ≈ ``softmax``          (lib/util.c:15, column-wise,
                                                max-subtracted for stability)
- ``softmax_row_wise``  ≈ ``softmax_row_wise`` (lib/util.c:36)
- ``silu``              x·σ(x), the ADM U-Net's activation
                        (``models/adm_unet.py``; the reference has none)

Each is a ``torch.autograd.Function`` whose backward is the JAX package's
hand-written rule:

- ReLU': ``g * (x > 0)`` on the pre-activation values
  (model/mnist_nn.c:273-278).
- SiLU': ``g · σ(x)·(1 + x·(1 − σ(x)))``, in at least f32 from the saved
  input.
- Softmax: the full Jacobian ``dx = y ⊙ (g − ⟨g, y⟩)`` per softmax vector
  (model/cifar_unet.c:1246-1258); the max subtracted before the exp takes no
  gradient.
"""

from __future__ import annotations

import torch


class _Relu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x > 0)
        return torch.clamp_min(x, 0)

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return torch.where(mask, g, 0).to(g.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0); NaN propagates, as with ``jnp.maximum``."""
    return _Relu.apply(x)


class _Silu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        return (xf * torch.sigmoid(xf)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        s = torch.sigmoid(xf)
        return (g.to(xf.dtype) * s * (1.0 + xf * (1.0 - s))).to(g.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x·σ(x) (swish), computed in at least f32 and returned in x's
    dtype."""
    return _Silu.apply(x)


class _Softmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        # the per-vector max, as the reference tracks it (lib/util.c:15-33)
        e = torch.exp(x - torch.amax(x, dim=axis, keepdim=True))
        y = e / torch.sum(e, dim=axis, keepdim=True)
        ctx.axis = axis
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        inner = torch.sum(g * y, dim=ctx.axis, keepdim=True)
        return (y * (g - inner)).to(g.dtype), None


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Column-wise softmax (each column sums to 1) for (classes, batch)
    layouts. ≈ ``softmax`` (lib/util.c:15)."""
    return _Softmax.apply(x, 0)


def softmax_row_wise(x: torch.Tensor) -> torch.Tensor:
    """Row-wise softmax (each row sums to 1), as on attention score rows.
    ≈ ``softmax_row_wise`` (lib/util.c:36)."""
    return _Softmax.apply(x, -1)
