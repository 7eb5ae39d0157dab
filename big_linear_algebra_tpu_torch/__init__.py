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
(``utils/debug.py``), and the data- and sequence-parallel modes on
``torch.distributed`` (``parallel/``: the mesh, DP for the three
trainable programs, mnist_nn's DP×TP step, ring attention). The U-Net's
tensor parallelism and the pipeline modes are not ported yet.

This package imports ``torch`` and numpy, never ``jax`` and never the JAX
package. Importing it switches TF32 off (``ops/precision.py``).
"""

__version__ = "0.1.0"

from big_linear_algebra_tpu_torch.ops import precision as _precision

_precision.apply()
