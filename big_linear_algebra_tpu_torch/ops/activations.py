"""Activations, the counterpart of ``big_linear_algebra_tpu/ops/activations.py``.

Ported so far: ``relu`` (lib/util.c:7), a ``torch.autograd.Function`` whose
backward is the JAX package's hand-written ``g * (x > 0)`` on the
pre-activation values (model/mnist_nn.c:273-278).
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
