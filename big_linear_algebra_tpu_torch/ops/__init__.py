"""Matrix core: the GEMM (kernel K1, ``ops/matmul.py``), ``relu``
(``ops/activations.py``), the kernel build helpers (``ops/cuda_utils.py``),
the precision policy (``ops/precision.py``) and the guard of the
forward-only ops (``ops/forward_only.py``).

The GEMM functions are not re-exported here, so that
``big_linear_algebra_tpu_torch.ops.matmul`` always names the module (and its
``launch_count``), never the function."""
