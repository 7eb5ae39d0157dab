"""Run ``chip_smoke.py``'s phase 27 alone: the JAX package's XLA dispatch
modes as replayed CUDA graphs (``utils/graphs.py``) against the eager steps
(the graphed sampler's image, the graphed train epoch's train state against
``--host-loop``'s, ``TrainSteps`` against ``train_step`` at 64x64 bf16,
32x32 ``--fused-block``, ``--remat``, ``--bf16-params``, ``--layout=NHWC``
and ``--scan-steps=5`` with a ragged tail, mnist_nn's resident epoch, the
launch counters against the profiler's kernels, and the timings).

    python3 tools/graph_check.py                 # on the card
    python3 tools/graph_check.py --device=cpu    # here, no card

On the card it builds the kernels the phase launches (K1, K2, K2c/K2d and
K5's two sources), then in a temporary data directory synthesizes the
CIFAR batches, runs ``cifar_unet init`` (the tree phase 27 starts from;
the full script gives it phase 10's trained tree) and the phase. With
``--device=cpu`` it rehearses the phase on the TINY net, the CPU's eager
steps standing in for the graphs: the same comparisons, no kernel launched
(every count must be 0), no timing of the device.
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
        names = ("matmul", "flash_attn", "flash_attn_bwd", "fused_block",
                 "fused_block_tc")
        t0 = time.perf_counter()
        cuda_utils.build(names)
        for name in names:
            cuda_utils.load_library(name)
        print(f"[2 build] {', '.join(f'csrc/{n}.cu' for n in names)} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    from big_linear_algebra_tpu_torch.data import synth
    from big_linear_algebra_tpu_torch.models import cifar_unet as cu

    tiny = ["--tiny"] if device == "cpu" else []
    with tempfile.TemporaryDirectory(prefix="bla_smoke_") as tmp:
        os.environ["BLA_DATA_DIR"] = tmp
        with contextlib.redirect_stdout(io.StringIO()):
            synth.ensure_cifar(tmp)
            if cu.main(["init", *tiny]) != 0:
                raise SystemExit("cifar_unet init failed")
        del os.environ["BLA_DATA_DIR"]
        chip_smoke.phase_graphs(tmp, smi_line, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
