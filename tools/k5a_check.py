"""Check the fused resnet block's kernels (K5a on both routes, K5b) on one
card, without the rest of ``chip_smoke.py``: the tensor-core K5a's build
record (registers, shared memory, spills, HMMA, occupancy), its cases
against the plain version and two runs bit-equal, phase 11's K5a/K5b
cases, then phase 12's timings (unless ``--no-timing``).

    python3 tools/k5a_check.py [--no-timing]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    smi_line, _ = chip_smoke.phase_environment()
    cuda_utils.build(["fused_block", "fused_block_tc"])
    print("\n".join(line for line in cuda_utils.build_log(
        "fused_block_tc").splitlines() if "ptxas" in line), flush=True)
    chip_smoke.phase_k5a_tc_build_info()
    chip_smoke.phase_k5a_tc_vs_plain()
    chip_smoke.phase_k5_vs_plain()
    if "--no-timing" not in sys.argv[1:]:
        chip_smoke.phase_k5_timing()
    print(smi_line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
