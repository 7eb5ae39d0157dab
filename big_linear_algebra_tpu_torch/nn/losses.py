"""Losses, the counterpart of ``big_linear_algebra_tpu/nn/losses.py``.

- ``softmax_cross_entropy``: fused softmax + CE with the reference's
  ``log(p + 1e-15)`` epsilon (model/mnist_nn.c:15,83-90), summed over the
  examples, with an optional per-example mask for a ragged batch
  (model/mnist_nn.c:194-195). A ``torch.autograd.Function`` whose backward
  is the reference's seed ``(softmax − onehot)·g``, masked per example
  (model/mnist_nn.c:263-268): the softmax itself is never differentiated.
- ``mse_loss``: the sum of squared errors (the U-Net's loss), a
  ``torch.autograd.Function`` with the reference's seed ``2·(pred − target)``
  (lib/layer.c:86-88, model/cifar_unet.c:1353-1364), and an optional (B,)
  per-example mask that weights the squares.
- ``cross_entropy_loss``: CE given probabilities, a metric only.
- ``hinge_loss``: one-vs-rest linear hinge with the subgradient
  ``−Σ_{margin<1} y·x`` (model/mnist_hinge.c:137-149, intended sign
  semantics, SURVEY.md §7.9), with the same optional mask. Its products are
  ``torch.matmul``, as the JAX package's are XLA's and not its kernel's.
"""

from __future__ import annotations

from typing import Optional

import torch

LOSS_EPSILON = 1e-15  # model/mnist_nn.c:15


def _masked_sum(x: torch.Tensor, mask: Optional[torch.Tensor]):
    return torch.sum(x * mask if mask is not None else x)


class _SoftmaxCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, onehot, mask):
        p = torch.softmax(logits, dim=-1)
        ce = -torch.sum(onehot * torch.log(p + LOSS_EPSILON), dim=-1)
        ctx.save_for_backward(p, onehot, mask)
        return _masked_sum(ce, mask)

    @staticmethod
    def backward(ctx, g):
        p, onehot, mask = ctx.saved_tensors
        dz = (p - onehot) * g
        if mask is not None:
            dz = dz * mask[:, None]
        return dz.to(p.dtype), None, None


def softmax_cross_entropy(logits: torch.Tensor, onehot: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ_examples CE(softmax(logits), onehot). logits: (B, C); returns the
    summed loss (callers divide, as the reference does per epoch at
    model/mnist_nn.c:339-340). ``mask``: optional (B,) per-example
    validity."""
    return _SoftmaxCrossEntropy.apply(logits, onehot, mask)


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


def cross_entropy_loss(probs: torch.Tensor,
                       onehot: torch.Tensor) -> torch.Tensor:
    """CE given probabilities (≈ cross_entropy_loss, model/mnist_nn.c:83):
    −Σ y·log(p + ε). A metric only: it has no hand-written backward."""
    return -torch.sum(onehot * torch.log(probs + LOSS_EPSILON))


class _HingeLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, x, y, mask):
        margins = y * torch.matmul(x, w)
        ctx.save_for_backward(x, y, margins, mask)
        return _masked_sum(torch.clamp_min(1.0 - margins, 0.0), mask)

    @staticmethod
    def backward(ctx, g):
        x, y, margins, mask = ctx.saved_tensors
        viol = (margins < 1.0).to(x.dtype)
        if mask is not None:
            viol = viol * mask.to(x.dtype)
        dw = -torch.matmul(viol * y, x) * g
        return dw.to(x.dtype), None, None, None


def hinge_loss(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-vs-rest linear hinge: Σ_i max(0, 1 − y_i·(x_i @ w)).

    w: (features,), x: (B, features), y: (B,) in {−1, +1}; ``mask``:
    optional (B,) per-example validity. Subgradient w.r.t. w:
    ``−Σ_{margin<1} y_i·x_i`` (model/mnist_hinge.c:137-149)."""
    return _HingeLoss.apply(w, x, y, mask)
