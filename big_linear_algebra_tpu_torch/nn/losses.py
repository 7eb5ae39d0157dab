"""Losses, the counterpart of ``big_linear_algebra_tpu/nn/losses.py``.

- ``softmax_cross_entropy``: fused softmax + CE with the reference's
  ``log(p + 1e-15)`` epsilon (model/mnist_nn.c:15,83-90), summed over the
  examples, with an optional per-example mask for a ragged batch. Forward
  only: its seed ``softmax − onehot`` comes with ``mnist_nn train``.
- ``mse_loss``: the sum of squared errors (the U-Net's loss), a
  ``torch.autograd.Function`` with the reference's seed ``2·(pred − target)``
  (lib/layer.c:86-88, model/cifar_unet.c:1353-1364), and an optional (B,)
  per-example mask that weights the squares.

Hinge comes with the model that uses it.
"""

from __future__ import annotations

from typing import Optional

import torch

LOSS_EPSILON = 1e-15  # model/mnist_nn.c:15


def softmax_cross_entropy(logits: torch.Tensor, onehot: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ_examples CE(softmax(logits), onehot). logits: (B, C); returns the
    summed loss (callers divide, as the reference does per epoch at
    model/mnist_nn.c:339-340)."""
    p = torch.softmax(logits, dim=-1)
    ce = -torch.sum(onehot * torch.log(p + LOSS_EPSILON), dim=-1)
    if mask is not None:
        ce = ce * mask
    return torch.sum(ce)


class _MseLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, target, mask):
        d = pred - target
        if mask is not None:
            # weight the squares by m (Σ m·d²) and seed 2·m·d; premasking d
            # would compute Σ m²·d², wrong for fractional weights
            m = mask.reshape((-1,) + (1,) * (d.ndim - 1)).to(d.dtype)
            md = m * d
            ctx.save_for_backward(md)
            return torch.sum(m * d * d)
        ctx.save_for_backward(d)
        return torch.sum(d * d)

    @staticmethod
    def backward(ctx, g):
        (md,) = ctx.saved_tensors
        seed = (2.0 * md * g).to(md.dtype)
        return seed, -seed, None


def mse_loss(pred: torch.Tensor, target: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum of squared errors (≈ compute_mse_loss, model/cifar_unet.c:1858,
    which averages; the seed 2·(pred − target) implies the sum, which
    callers normalize). ``mask``: optional (B,) per-example weights."""
    return _MseLoss.apply(pred, target, mask)
