"""Matrix core: the GEMM (kernel K1, ``ops/matmul.py``), the kernel build
helpers (``ops/cuda_utils.py``) and the precision policy
(``ops/precision.py``).

The GEMM functions are not re-exported here, so that
``big_linear_algebra_tpu_torch.ops.matmul`` always names the module (and its
``launch_count``), never the function."""
