"""NN layers, losses and initializers (forward only so far)."""

from big_linear_algebra_tpu_torch.nn.dense import Dense, dense  # noqa: F401
from big_linear_algebra_tpu_torch.nn.init import he_uniform  # noqa: F401
from big_linear_algebra_tpu_torch.nn.losses import (  # noqa: F401
    LOSS_EPSILON,
    softmax_cross_entropy,
)
