"""Run ``chip_smoke.py``'s phase 26 alone: cifar_unet under
``--layout=NHWC`` and ``--remat`` (the channels-last twins against the NCHW
ops, ``run`` and ``train`` under NHWC, the f32 NHWC gradient, ``--remat``
bit-equal with its memory and time, and one two-rank ``train --dp
--layout=NHWC --remat`` launch).

    python3 tools/layout_remat_check.py                 # on the card
    python3 tools/layout_remat_check.py --device=cpu    # here, no card

On the card it builds the kernels the phase launches (K2, K2c/K2d and K5's
two sources), then in a temporary data directory synthesizes the CIFAR
batches, runs ``cifar_unet init`` and ``run 1 --image-size=64`` (phase 6's
NCHW run, whose K2 launches phase 26 matches) and the phase. With
``--device=cpu`` it rehearses the phase on the TINY net, the CPU's plain
path standing in for the card: the same checks, no kernel launched (every
count must be 0), no memory or busy share.
"""

import contextlib
import io
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--device=cpu"]):
        print(__doc__)
        return 1
    device = "cpu" if argv else "cuda"
    smi_line = "the CPU rehearsal"
    if device == "cuda":
        from big_linear_algebra_tpu_torch.ops import cuda_utils

        smi_line, _ = chip_smoke.phase_environment()
        names = ("flash_attn", "flash_attn_bwd", "fused_block",
                 "fused_block_tc")
        t0 = time.perf_counter()
        cuda_utils.build(names)
        for name in names:
            cuda_utils.load_library(name)
        print(f"[2 build] {', '.join(f'csrc/{n}.cu' for n in names)} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    from big_linear_algebra_tpu_torch.data import synth
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu
    from big_linear_algebra_tpu_torch.nn import attention as at

    tiny = ["--tiny"] if device == "cpu" else []
    with tempfile.TemporaryDirectory(prefix="bla_smoke_") as tmp:
        os.environ["BLA_DATA_DIR"] = tmp
        with contextlib.redirect_stdout(io.StringIO()):
            synth.ensure_cifar(tmp)
            if cu.main(["init", *tiny]) != 0:
                raise SystemExit("cifar_unet init failed")
            at.launch_count = 0
            if cu.main(["run", "1", "--image-size=64", "--sample-seed=0",
                        f"--device={device}", *tiny]) != 0:
                raise SystemExit("cifar_unet run failed")
        chip_smoke.phase_nhwc_remat(tmp, at.launch_count, smi_line, device)
        del os.environ["BLA_DATA_DIR"]
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
