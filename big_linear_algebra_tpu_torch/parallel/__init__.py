"""Distribution on ``torch.distributed``, the counterpart of
``big_linear_algebra_tpu/parallel``: rank meshes, DP/TP shardings,
collectives, sequence-sharded ring attention, and the pipeline schedules.

Each rank is one process driving one device; a step is written per shard
with explicit collectives (``spmd``), as the JAX package writes its
``shard_map`` steps. The model-specific parallel steps live next to their
models (``models/mnist_nn.py``, ``models/mnist_hinge.py``,
``models/cifar_unet.py``); the pipeline schedules are in ``pipeline``.
"""

from big_linear_algebra_tpu_torch.parallel.mesh import (  # noqa: F401
    default_mesh,
    distributed_init,
    local_device_count,
    make_hybrid_mesh,
    make_mesh,
)
from big_linear_algebra_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_sharding,
    replicate,
    shard_params_tp,
)
from big_linear_algebra_tpu_torch.parallel.pipeline import (  # noqa: F401
    gpipe,
)
from big_linear_algebra_tpu_torch.parallel.ring_attention import (  # noqa: F401
    ring_attention,
)
