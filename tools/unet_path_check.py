"""Time the U-Net's CLI paths of one checkout on one card, without the
rest of ``chip_smoke.py``: its phase 6 (``cifar_unet init`` + ``run 1
--image-size=64``), phase 7 (the oracle forward, then one bf16 forward's
host and device time), phase 9 (``train 1 --image-size=64
--max-steps=50`` and its resume) and phase 10's train-step time (one bf16
train step's host and device time), with their checks.

    python3 tools/unet_path_check.py [TREE]

TREE (default: this checkout) is the checkout whose ``chip_smoke.py`` and
packages run, so that two commits can be compared in one call on one
card: unpack the other one with ``git archive`` and run this script on
each in turn (A, B, B, A). The kernels are built before any phase, so
that no build falls into a timed run.
"""

import os
import sys
import tempfile

TREE = os.path.abspath(sys.argv[1] if sys.argv[1:] else os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir))
sys.path.insert(0, TREE)
os.chdir(TREE)

import chip_smoke  # noqa: E402


def main() -> int:
    import dataclasses

    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    if not chip_smoke.__file__.startswith(TREE + os.sep):
        chip_smoke.fail(f"imported {chip_smoke.__file__}, not {TREE}'s")
    smi_line, _ = chip_smoke.phase_environment()
    print(f"[tree] {TREE}", flush=True)
    cuda_utils.build(("matmul", "flash_attn", "flash_attn_bwd"))
    with tempfile.TemporaryDirectory(prefix="bla_unet_") as tmp:
        os.environ["BLA_DATA_DIR"] = tmp
        chip_smoke.phase_unet_main_path(tmp)
        chip_smoke.phase_unet_oracle()
    with tempfile.TemporaryDirectory(prefix="bla_unet_") as tmp:
        os.environ["BLA_DATA_DIR"] = tmp
        chip_smoke.phase_unet_train(tmp)
        params = cu.load_params_csv(
            dataclasses.replace(cu.CONFIG, image_size=64))
        chip_smoke.phase_train_step_time(cu, params)
    del os.environ["BLA_DATA_DIR"]
    print(smi_line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
