"""The guard of every forward-only op whose JAX counterpart has a
hand-written backward (``jax.custom_vjp``).

Until that backward is ported, such an op raises when autograd would need a
graph through it: a ctypes kernel launch would cut the graph silently, and a
plain torch path would differentiate something other than the hand-written
backward. Under ``torch.no_grad()`` or ``torch.inference_mode()`` it runs.
"""

from __future__ import annotations

from typing import Optional

import torch


def check(what: str, *tensors: Optional[torch.Tensor]) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} is forward-only until its hand-written backward is "
            "ported; call it under torch.no_grad() or "
            "torch.inference_mode()")
