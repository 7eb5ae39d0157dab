"""Check the flash-attention backward kernels (K2c, K2d) on one card,
without the rest of ``chip_smoke.py``: phase 8's cases against the plain
version, two runs bit-equal, the timings beside the plain backward and
SDPA's, and the tensor-core kernels' registers, shared memory, spills and
SASS.

    python3 tools/flash_bwd_check.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    smi_line, exp2_per_s = chip_smoke.phase_environment()
    chip_smoke.phase_k2bwd_vs_plain()
    chip_smoke.phase_k2bwd_bitequal()
    chip_smoke.phase_k2bwd_timing(exp2_per_s)
    chip_smoke.phase_k2bwd_build_info()
    print(smi_line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
