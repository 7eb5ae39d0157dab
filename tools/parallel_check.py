"""Run ``chip_smoke.py``'s phase 24 alone: the data- and sequence-parallel
modes, ranks launched with ``python3 -m torch.distributed.run --standalone
--nproc-per-node=N``.

    python3 tools/parallel_check.py                       # on one card
    python3 tools/parallel_check.py --ranks=4 --spawned   # on four cards
    python3 tools/parallel_check.py --device=cpu          # here, no card

On the card it builds the kernels the phase launches (K1, K2, K2c/K2d and
K5's two sources) and runs the phase with 2 ranks (``--ranks=N``: N), which
share one card over gloo, or own a card each over NCCL where there are as
many. ``--spawned`` first runs mnist_nn ``train 1 --dp`` launched plainly
on a node with several cards (the CLI spawns one rank per card) beside the
single-device ``train 1`` from the same CSVs, each held to the f64 epoch
on the CPU as phase 22 holds it. With ``--device=cpu`` it rehearses the
phase over gloo CPU ranks, the CPU's f32 plain path standing in for the
card: the same checks, with the TINY U-Net in place of the full-width one,
smaller ring-attention shapes, no kernel launched (every count must be 0)
and no profile.
"""

import contextlib
import io
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _train(where: str, dp: bool) -> tuple:
    """mnist_nn ``train 1`` (with ``--dp``: launched plainly) in a new
    process with ``BLA_DATA_DIR=where``: (stdout, seconds)."""
    cmd = [sys.executable, "-m", "big_linear_algebra_tpu_torch.models."
           "mnist_nn", "train", "1"] + (["--dp"] if dp else [])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ,
                                                BLA_DATA_DIR=where))
    if proc.returncode != 0:
        chip_smoke.fail(f"{' '.join(cmd[2:])} exited {proc.returncode}:\n"
                        f"{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    return proc.stdout, time.perf_counter() - t0


def spawned_check(smi_line: str) -> None:
    """mnist_nn ``train 1 --dp`` launched plainly on a node with several
    cards (one rank per card, NCCL) beside ``train 1`` on one card, from the
    same CSVs and permutation: every leaf of each within
    ``TRAIN_RTOL_OF_UPDATE`` of its update from the f64 epoch on the CPU."""
    import torch

    from big_linear_algebra_tpu_torch.data import synth
    from big_linear_algebra_tpu_torch.models import mnist_nn

    n = torch.cuda.device_count()
    if n < 2:
        chip_smoke.fail(f"--spawned needs a node with several cards, have {n}")
    with tempfile.TemporaryDirectory(prefix="bla_check_") as tmp:
        where = os.path.join(tmp, "mnist")
        os.environ["BLA_DATA_DIR"] = where
        with contextlib.redirect_stdout(io.StringIO()):
            synth.ensure_mnist(where)
            mnist_nn.main(["init"])
        initial = mnist_nn.load_params_csv()
        single = os.path.join(tmp, "single")
        shutil.copytree(where, single)
        text, dp_s = _train(where, dp=True)
        one, one_s = _train(single, dp=False)
        ref, _ = chip_smoke._mnist_f64_epoch(initial, tmp)
        ratios = {}
        for name, base in (("--dp", where), ("one card", single)):
            got = mnist_nn.load_params_csv(os.path.join(base, "mnist_nn"))
            ratios[name] = chip_smoke._of_update(got, ref, initial)
            if not max(ratios[name].values()) <= \
                    chip_smoke.TRAIN_RTOL_OF_UPDATE:
                chip_smoke.fail(f"mnist_nn train 1 ({name}) against the f64 "
                                f"epoch: {ratios[name]}")
        del os.environ["BLA_DATA_DIR"]
    if f"torch.distributed: {n} ranks, backend nccl" not in text:
        chip_smoke.fail(f"train 1 --dp did not run {n} ranks on NCCL:\n{text}")
    line, line1 = (chip_smoke._epoch_line(t, 0) for t in (text, one))
    print(f"[24 spawned] mnist_nn train 1 --dp launched plainly on {n} cards "
          f"(one rank each, NCCL): {float(line['images_per_sec']):.1f} "
          f"images/s, {dp_s:.2f} s of wall with the spawn; train 1 on one "
          f"card {float(line1['images_per_sec']):.1f} images/s; against the "
          f"f64 epoch (the CSVs' six decimals), max|err| / max|update| per "
          f"leaf --dp " + ", ".join(f"{k} {v:.3e}" for k, v in
                                    ratios["--dp"].items())
          + ", one card " + ", ".join(f"{k} {v:.3e}" for k, v in
                                      ratios["one card"].items())
          + f" (tol {chip_smoke.TRAIN_RTOL_OF_UPDATE}) | {smi_line}",
          flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ranks = chip_smoke.P24_RANKS
    flags = set()
    for a in argv:
        if a.startswith("--ranks=") and a[8:].isdigit() and int(a[8:]) >= 2:
            ranks = int(a[8:])
        elif a in ("--device=cpu", "--spawned"):
            flags.add(a)
        else:
            print(__doc__)
            return 1
    if "--device=cpu" in flags:
        chip_smoke.phase_parallel("the CPU rehearsal", device="cpu",
                                  n_ranks=ranks)
        return 0
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
    if "--spawned" in flags:
        spawned_check(smi_line)
    chip_smoke.phase_parallel(smi_line, n_ranks=ranks)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
