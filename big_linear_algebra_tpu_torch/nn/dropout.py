"""Dropout, the counterpart of ``big_linear_algebra_tpu/nn/dropout.py``
(≈ ``_dropout``, model/cifar_unet.c:1032-1042).

Inverted dropout as in the JAX package: survivors are scaled by 1/(1−p), so
eval needs no scaling. The mask comes from an explicit ``torch.Generator`` on
x's device; its bits differ from the JAX package's keys, the distribution is
the same. The output keeps x's memory layout (a channels-last view stays
channels-last).
"""

from __future__ import annotations

from typing import Optional

import torch


def dropout_mask(shape, rate: float, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """The elements ``dropout`` drops (True), drawn from ``generator``."""
    return torch.rand(shape, generator=generator, device=device) >= 1.0 - rate


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            deterministic: bool = False,
            drop: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``drop``: the mask to apply (``dropout_mask``) instead of drawing
    one."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    if drop is None:
        drop = dropout_mask(x.shape, rate, generator, x.device)
    # in x's layout (torch.where would lay its output out as the mask)
    return (x / keep).masked_fill_(drop, 0.0).to(x.dtype)
