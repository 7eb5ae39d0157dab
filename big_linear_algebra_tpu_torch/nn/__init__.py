"""NN layers and losses, each with its hand-written backward, and the
initializers.

The U-Net layers live in their modules (``nn.norm``, ``nn.conv``,
``nn.dropout``, ``nn.attention``) and are not re-exported here, so that
``big_linear_algebra_tpu_torch.nn.attention`` always names the module (and
its ``launch_count``), never a function."""

from big_linear_algebra_tpu_torch.nn.dense import Dense, dense  # noqa: F401
from big_linear_algebra_tpu_torch.nn.init import (  # noqa: F401
    he_uniform,
    uniform_init,
    xavier_uniform,
)
from big_linear_algebra_tpu_torch.nn.losses import (  # noqa: F401
    LOSS_EPSILON,
    cross_entropy_loss,
    hinge_loss,
    softmax_cross_entropy,
)
