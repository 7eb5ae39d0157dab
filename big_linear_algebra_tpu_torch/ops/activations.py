"""Activations, the counterpart of ``big_linear_algebra_tpu/ops/activations.py``.

Ported so far: ``relu`` (lib/util.c:7), forward only (its hand-written
backward ``g * (x > 0)`` comes with training).
"""

from __future__ import annotations

import torch

from big_linear_algebra_tpu_torch.ops import forward_only


def relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0); NaN propagates, as with ``jnp.maximum``."""
    forward_only.check("relu", x)
    return torch.clamp_min(x, 0)
