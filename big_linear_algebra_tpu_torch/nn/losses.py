"""Losses, the counterpart of ``big_linear_algebra_tpu/nn/losses.py``.

- ``softmax_cross_entropy``: fused softmax + CE with the reference's
  ``log(p + 1e-15)`` epsilon (model/mnist_nn.c:15,83-90), summed over the
  examples, with an optional per-example mask for a ragged batch.

Forward only: the hand-written seed ``softmax − onehot`` comes with training,
and MSE and hinge come with the models that use them.
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
