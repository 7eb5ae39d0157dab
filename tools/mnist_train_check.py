"""Check the mnist_nn path on one card without the rest of
``chip_smoke.py``: K1 alone (phase 3: against the plain version, the TF32
control, two runs bit-equal, the build record and grids, the timings at the
layer shapes and at the train step's K1 GEMMs), then ``mnist_nn init`` +
``run`` (phase 4) and ``init`` + ``train 1`` + ``run`` (phase 22).

    python3 tools/mnist_train_check.py

Builds only ``csrc/matmul.cu``; about a minute of command time.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    chip_smoke.phase_environment()
    t0 = time.perf_counter()
    cuda_utils.build(("matmul",))
    cuda_utils.load_library("matmul")
    print(f"[2 build] csrc/matmul.cu in {time.perf_counter() - t0:.2f} s",
          flush=True)
    chip_smoke.phase_kernel_vs_plain()
    chip_smoke.phase_tf32_control()
    chip_smoke.phase_k1_bitequal()
    chip_smoke.phase_k1_build_info()
    chip_smoke.phase_timing()
    chip_smoke.phase_train_gemm_timing()
    chip_smoke.phase_main_path()
    chip_smoke.phase_mnist_train()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
