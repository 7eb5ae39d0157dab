"""Run ``chip_smoke.py``'s phase 23 alone: my_first_model, legacy mnist,
mnist_hinge and smoke through their CLIs, each held against f64 on the CPU,
and the ``--debug-nans`` / ``--disable-jit`` flags on mnist_nn.

    python3 tools/legacy_programs_check.py               # on one card
    python3 tools/legacy_programs_check.py --device=cpu  # here, no card

On the card it first runs phase 22 (mnist_nn ``train 1``, building only
``csrc/matmul.cu``), whose initial and trained parameters phase 23's debug
check starts from. With ``--device=cpu`` the CPU's f32 plain path stands in
for the card: the same checks, with mnist_nn's ``train 1`` run on the CPU
for the debug check and no timing or profile, after the f32 and f64
trajectories of the legacy mnist and mnist_hinge side by side. Its numbers
are the reckoning of phase 23's bounds (``chip_smoke.py``, the constants
after "Phase 23").
"""

import contextlib
import io
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def _cpu_phase22() -> dict:
    """mnist_nn ``init`` + ``train 1 --device=cpu`` in a temporary
    directory: the initial and trained parameters, as phase 22 hands them
    over (K1 is not launched on the CPU)."""
    from big_linear_algebra_tpu_torch.models import mnist_nn

    with tempfile.TemporaryDirectory(prefix="bla_check_") as tmp:
        os.environ["BLA_DATA_DIR"] = tmp
        with contextlib.redirect_stdout(io.StringIO()):
            mnist_nn.main(["init"])
            initial = mnist_nn.load_params_csv()
            with chip_smoke._saved(mnist_nn, "save_params_csv") as saved:
                rc = mnist_nn.main(["train", "1", "--device=cpu"])
        del os.environ["BLA_DATA_DIR"]
    if rc != 0:
        chip_smoke.fail(f"mnist_nn train 1 --device=cpu exited {rc}")
    return {"initial": initial, "trained": saved[0],
            "counts": {"nn": 0, "nt": 0, "tn": 0}}


def _trajectories() -> None:
    """Why phase 23 holds the legacy mnist and mnist_hinge step by step:
    the same steps in f32 and in f64 on the CPU's plain path, from the same
    initial CSVs and stream, part by this much of each leaf's update."""
    import torch

    from big_linear_algebra_tpu_torch.data import synth
    from big_linear_algebra_tpu_torch.data.mnist import MnistDataset
    from big_linear_algebra_tpu_torch.models import mnist as legacy
    from big_linear_algebra_tpu_torch.models import mnist_hinge as hinge
    from big_linear_algebra_tpu_torch.nn import layer_graph as lg

    def apart(got, want, start):
        return max(float((g.double() - w).abs().max()
                         / (w - s.double()).abs().max())
                   for g, w, s in zip(got, want, start))

    lines = []
    with tempfile.TemporaryDirectory(prefix="bla_check_") as tmp:
        os.environ["BLA_DATA_DIR"] = tmp
        with contextlib.redirect_stdout(io.StringIO()):
            train_csv, _ = synth.ensure_mnist(tmp)
            xs, ys = legacy.stream_examples(train_csv, 1000)
            for flags in ({}, {"he-init": ""}):
                legacy.init(flags=flags)
                start = legacy.load_params()
                ends = [lg.make_sgd_scan(legacy.ACTS)(
                    [(w.to(dt), b.to(dt)) for w, b in start],
                    torch.from_numpy(xs).to(dt), torch.from_numpy(ys).to(dt),
                    chip_smoke.LEGACY_MNIST_LR)[0]
                    for dt in (torch.float32, torch.float64)]
                lines.append(
                    f"legacy mnist{' --he-init' * bool(flags)}, 1000 steps: "
                    f"f32 ends {apart(*map(chip_smoke._flat, ends), chip_smoke._flat(start)):.3e}")
            hinge.init()
            w0 = hinge.load_weights()
            data = MnistDataset.from_csv(train_csv)
            ends = []
            for dt in (torch.float32, torch.float64):
                x = torch.from_numpy(data.x / 255.0).to(dt)
                w = w0.to(dt)
                for _ in range(chip_smoke.HINGE_ITERATIONS):
                    w, _ = hinge.train_chunk(
                        w, x, hinge.signed_targets(torch.from_numpy(data.y),
                                                   dt),
                        chip_smoke.HINGE_LR, 1)
                ends.append([w])
            lines.append(f"mnist_hinge, 100 iterations: f32 ends "
                         f"{apart(*ends, [w0]):.3e}")
        del os.environ["BLA_DATA_DIR"]
    print("[trajectories, the CPU's plain path] " + "; ".join(lines)
          + " of the largest leaf update from f64", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--device=cpu"]):
        print(__doc__)
        return 1
    if argv:
        _trajectories()
        chip_smoke.phase_legacy_programs(_cpu_phase22(), device="cpu")
        return 0
    from big_linear_algebra_tpu_torch.ops import cuda_utils

    chip_smoke.phase_environment()
    t0 = time.perf_counter()
    cuda_utils.build(("matmul",))
    cuda_utils.load_library("matmul")
    print(f"[2 build] csrc/matmul.cu in {time.perf_counter() - t0:.2f} s",
          flush=True)
    _, p22 = chip_smoke.phase_mnist_train()
    chip_smoke.phase_legacy_programs(p22)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
