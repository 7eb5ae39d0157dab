"""Parameter initializers, the counterpart of
``big_linear_algebra_tpu/nn/init.py``.

Every draw takes an explicit ``torch.Generator``. PyTorch's and JAX's
generators give different numbers from the same seed: the distributions match
the JAX package's, the values do not.

- ``he_uniform``: U(−√(6/fan_in), +√(6/fan_in)) — model/mnist_nn.c:97-142.
- ``xavier_uniform``: U(−√6/√(fan_in+fan_out), +…) —
  model/cifar_unet.c:1447-1454.
- ``uniform_init``: U(−0.5, 0.5) — model/mnist.c:218-249; with ``scale``
  for mnist_hinge's scaled uniform (model/mnist_hinge.c:14-25).
"""

from __future__ import annotations

import math

import torch


def he_uniform(shape, fan_in: int, generator: torch.Generator,
               dtype=torch.float32, device=None) -> torch.Tensor:
    limit = math.sqrt(6.0 / fan_in)
    out = torch.empty(shape, dtype=dtype, device=device)
    return out.uniform_(-limit, limit, generator=generator)


def xavier_uniform(shape, fan_in: int, fan_out: int,
                   generator: torch.Generator, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    limit = math.sqrt(6.0) / math.sqrt(float(fan_in + fan_out))
    out = torch.empty(shape, dtype=dtype, device=device)
    return out.uniform_(-limit, limit, generator=generator)


def uniform_init(shape, generator: torch.Generator, scale: float = 1.0,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=device)
    return out.uniform_(-0.5 * scale, 0.5 * scale, generator=generator)
