"""big-linear-algebra-tpu, ported to PyTorch and CUDA (NVIDIA Hopper).

The second package of the repository: the JAX package
``big_linear_algebra_tpu`` is the reference, and every module here keeps the
name of its counterpart there. Plain tensor code is PyTorch; every Pallas
kernel of the JAX package on a ported path is a CUDA C++ kernel written for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use
(``ops/cuda_utils.py``) and bound through ctypes.

Ported so far: the serving paths (``init`` and ``run``) of mnist_nn
(``models/mnist_nn.py``), with the GEMM (``ops/matmul.py``, kernel
``csrc/matmul.cu``), and of the cifar_unet DDPM sampler
(``models/cifar_unet.py``), with flash attention (``nn/attention.py``,
kernel ``csrc/flash_attn.cu``).

This package imports ``torch`` and numpy, never ``jax`` and never the JAX
package. Importing it switches TF32 off (``ops/precision.py``).
"""

__version__ = "0.1.0"

from big_linear_algebra_tpu_torch.ops import precision as _precision

_precision.apply()
