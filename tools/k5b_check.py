"""Check the fused resnet block's backward (K5b) on one card, without the
rest of ``chip_smoke.py``: its tensor-core kernels' build record
(registers, shared memory, spills, HMMA, occupancy), its cases against the
plain version and two runs bit-equal (phase 11's K5b parts), phase 12's
timing of K5b's two kernels apart, then the profile of one bf16 ``train
--fused-block`` step at batch 16 (phase 15's configuration, random weights
from seed 0) with K5b on its route and forced onto the FMA route.

    python3 tools/k5b_check.py [--data-route=fma] [--no-profile]

``--data-route=fma`` sends every data-gradient launch (and so every
weight-gradient launch, which follows it) to the FMA kernels of
``csrc/fused_block.cu`` and skips the tensor-core checks: the backward as
it ran before its tensor-core kernels.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import fused_block as fb
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    smi_line, _ = chip_smoke.phase_environment()
    cuda_utils.build(["fused_block", "fused_block_tc"])
    if "--data-route=fma" in sys.argv[1:]:
        fb._bwd_route = lambda *shape: "fma"
    else:
        print("\n".join(line for line in cuda_utils.build_log(
            "fused_block_tc").splitlines() if "ptxas" in line), flush=True)
        chip_smoke.phase_k5b_tc_build_info()
        chip_smoke.phase_k5b_tc_vs_plain()
    chip_smoke.phase_k5b_timing()
    if "--no-profile" not in sys.argv[1:]:
        params = cu.init_params(torch.Generator().manual_seed(0), cu.CONFIG)
        chip_smoke.phase_fused_step_profile(params)
    print(smi_line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
