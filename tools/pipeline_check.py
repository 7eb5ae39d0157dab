"""Run ``chip_smoke.py``'s phase 25 alone: the U-Net's tensor parallelism
and the pipeline modes, ranks launched with ``python3 -m
torch.distributed.run --standalone --nproc-per-node=N`` (N = 2 for
``--tp``, 3 for ``--pp``, 6 for ``--pp --dp``).

    python3 tools/pipeline_check.py                 # on the card
    python3 tools/pipeline_check.py --device=cpu    # here, no card

On the card it builds the kernels the phase launches (K2, K2c/K2d and K5's
two sources) and runs the phase; the ranks share one card over gloo, or own
a card each over NCCL where there are as many. With ``--device=cpu`` it
rehearses the phase over gloo CPU ranks, the CPU's f32 plain path standing
in for the card: the same checks on the TINY U-Net at batch 4, no kernel
launched (every count must be 0) and no busy share.
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--device=cpu"]):
        print(__doc__)
        return 1
    if argv:
        chip_smoke.phase_tp_pp("the CPU rehearsal", device="cpu")
        return 0
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    smi_line, _ = chip_smoke.phase_environment()
    names = ("flash_attn", "flash_attn_bwd", "fused_block", "fused_block_tc")
    t0 = time.perf_counter()
    cuda_utils.build(names)
    for name in names:
        cuda_utils.load_library(name)
    print(f"[2 build] {', '.join(f'csrc/{n}.cu' for n in names)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    chip_smoke.phase_tp_pp(smi_line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
