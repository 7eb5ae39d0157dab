"""big-linear-algebra-tpu, ported to PyTorch and CUDA (NVIDIA Hopper).

The second package of the repository: the JAX package
``big_linear_algebra_tpu`` is the reference, and every module here keeps the
name of its counterpart there. Plain tensor code is PyTorch; every Pallas
kernel of the JAX package on a ported path is a CUDA C++ kernel written for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use
(``ops/cuda_utils.py``) and bound through ctypes.

Ported so far: the five model programs' ``init | train | run`` CLIs
(``models/``: mnist_nn, cifar_unet, my_first_model, the legacy mnist,
mnist_hinge) and the smoke program, with every Pallas kernel of the JAX
package as a CUDA kernel (``csrc/``), and the debug helpers
(``utils/debug.py``), the parallel modes on ``torch.distributed``
(``parallel/``: the mesh, DP for the three trainable programs, mnist_nn's
DP×TP step, ring attention, the U-Net's tensor parallelism and the
pipeline modes), and the U-Net's ``--layout=NHWC`` (the channels-last
twins ``conv2d_nhwc``, ``group_norm_nhwc``, ``self_attention_block_nhwc``)
and ``--remat`` (per-block recompute that replays the block's draws),
and the XLA dispatch modes as replayed CUDA graphs (``utils/graphs.py``:
the sampler's loop, cifar_unet's device epoch with ``--scan-steps``,
``--scan-unroll`` and ``--host-loop``, mnist_nn's resident epoch, the
Layer graph's SGD scan and mnist_hinge's chunk, and the ``--dp`` and
``--tp`` epochs with their collectives inside when the ranks run over
NCCL, one card each). ``--pp`` trains one step a dispatch, as the JAX
package does. Not ported: ``--prng`` (the port draws from
``torch.Generator``).

This package imports ``torch`` and numpy, never ``jax`` and never the JAX
package. Importing it switches TF32 off (``ops/precision.py``).
"""

__version__ = "0.1.0"

from big_linear_algebra_tpu_torch.ops import precision as _precision

_precision.apply()
