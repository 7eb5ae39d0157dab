"""Run ``chip_smoke.py``'s phases 27 and 28 alone: the JAX package's XLA
dispatch modes as replayed CUDA graphs (``utils/graphs.py``) against the
eager steps.

    python3 tools/graph_check.py                  # phases 27 and 28, one card
    python3 tools/graph_check.py --phase=27       # (or 28) one of them
    python3 tools/graph_check.py --device=cpu     # here, no card
    python3 tools/graph_check.py --ranks=4 --spawned   # four cards, NCCL

Phase 27: the graphed sampler's image, the graphed train epoch's train
state against ``--host-loop``'s, ``TrainSteps`` against ``train_step`` at
64x64 bf16, 32x32 ``--fused-block``, ``--remat``, ``--bf16-params``,
``--layout=NHWC`` and ``--scan-steps=5`` with a ragged tail, mnist_nn's
resident epoch, the launch counters against the profiler's kernels, and the
timings. On the card it builds the kernels the phase launches (K1, K2,
K2c/K2d, K5's two sources and the in-place Adam pass), then in a temporary data directory
synthesizes the CIFAR batches, runs ``cifar_unet init`` (the tree phase 27
starts from; the full script gives it phase 10's trained tree) and the
phase.

Phase 28 on one card (``phase_graphs_legacy``): my_first_model, the legacy
mnist and mnist_hinge ``train`` graphed against ``graphs.eager()``
(bit-equal, stdout equal), their loops timed in turns, and a one-rank NCCL
world's all-reduce captured and replayed.

``--ranks=N --spawned`` (``phase_graphs_parallel``; N cards, one rank
each over NCCL): mnist_nn ``--dp``, mnist_hinge ``--dp``, cifar_unet
``--dp`` with and without ``--fused-block``, ``--tp`` and ``--tp
--scan-steps=2``, each graphed epoch bit-equal to its eager one on every
rank, the replicas bit-equal, the launches and collectives equal, host
time and busy share a step; and the cifar_unet ``--dp`` and ``--tp
--scan-steps=2`` CLIs against their eager runs (train states bit-equal).

With ``--device=cpu`` it rehearses the phases here on the TINY net (and
over gloo CPU ranks), the CPU's eager steps standing in for the graphs:
the same comparisons, no kernel launched (every count must be 0), no
timing of the device.
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


def _args(argv):
    """{flag: value} of ``--device=cpu``, ``--phase=27|28``, ``--ranks=N``
    and ``--spawned``, or None for anything else."""
    out = {}
    for a in argv:
        name, _, value = a.partition("=")
        if (name, value) in (("--device", "cpu"), ("--phase", "27"),
                             ("--phase", "28")) \
                or (name == "--ranks" and value.isdigit()) \
                or (a == "--spawned"):
            out[name] = value
        else:
            return None
    if ("--spawned" in out) != ("--ranks" in out) or (
            "--spawned" in out and "--phase" in out):
        return None
    return out


def _build(names) -> None:
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    t0 = time.perf_counter()
    cuda_utils.build(names)
    for name in names:
        cuda_utils.load_library(name)
    print(f"[2 build] {', '.join(f'csrc/{n}.cu' for n in names)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def main(argv=None) -> int:
    args = _args(sys.argv[1:] if argv is None else argv)
    if args is None:
        print(__doc__)
        return 1
    device = args.get("--device", "cuda")
    phases = [args["--phase"]] if "--phase" in args else ["27", "28"]
    smi_line = "the CPU rehearsal"
    if device == "cuda":
        smi_line, _ = chip_smoke.phase_environment()
    kernels = ("matmul", "flash_attn", "flash_attn_bwd", "fused_block",
               "fused_block_tc", "adam")
    if "--spawned" in args:
        if device == "cuda":
            _build(kernels)
        chip_smoke.phase_graphs_parallel(smi_line, device,
                                         int(args["--ranks"]))
        return 0
    if "27" in phases:
        if device == "cuda":
            _build(kernels)
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
    if "28" in phases:  # the legacy programs launch no kernel
        chip_smoke.phase_graphs_legacy(smi_line, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
