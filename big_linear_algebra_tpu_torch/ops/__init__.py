"""Matrix core: the GEMM (kernel K1, ``ops/matmul.py``) with its
hand-written backward, the ``lib/matrix.h`` surface (``ops/matrix.py``),
``relu`` and the softmaxes (``ops/activations.py``), the kernel build
helpers (``ops/cuda_utils.py``) and the precision policy
(``ops/precision.py``).

The GEMM functions are not re-exported here, so that
``big_linear_algebra_tpu_torch.ops.matmul`` always names the module (and its
``launch_count``), never the function."""
