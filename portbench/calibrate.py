"""The readings that a cell's limits are set from, on the card, in one
process: for each seed the program's numbers against the reference (the
lower reading is their largest), and on the first ``--controls`` seeds the
control's (the reference in float8, put in the program's place) and, for a
train cell, faults planted in the reference put in the program's place
(the upper reading is the smallest that fails):

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--controls 3]

The program runs its timed path at the cell's size: a train cell's checked
steps as a run's set-up drives them, a sample cell's one whole call.
Besides the numbers a limit may hold it prints statistics of every leaf's
or image's gap, for choosing among them. Prints one JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402
from portbench import reference as ref  # noqa: E402
from portbench.drivers import sample as sample_driver  # noqa: E402
from portbench.drivers import train as train_driver  # noqa: E402


def say(**kw) -> None:
    print(json.dumps(kw), flush=True)


def quantiles(values) -> dict:
    v = sorted(values)
    return {f"p{q}": v[round(q / 100 * (len(v) - 1))]
            for q in (10, 25, 50, 75, 90, 100)}


def leaf_statistics(got: dict, want: dict, model: dict) -> dict:
    """Of each part's gradient and update: every leaf's gap as a norm of
    differences and as a difference of norms, by quantile, and the five
    worst leaves by name."""
    paths = ref.leaf_paths(model)
    out = {}
    for part in ("start", "replay"):
        for name in ("grad", "update"):
            w, g = want[part][name], got[part][name]
            used = [i for i, x in enumerate(w) if x.any()]
            diff = train_driver.leaf_gaps(g, w, used)
            of_norms = train_driver.leaf_gaps(g, w, used, of_norms=True)
            worst = sorted(diff, key=diff.get, reverse=True)[:5]
            out[f"{name}.{part}"] = {
                "diff": quantiles(diff.values()),
                "norm": quantiles(of_norms.values()),
                "worst": [[paths[i], diff[i]] for i in worst]}
    return out


def no_v_correction(params, grads, m, v, step, lr):
    """Adam without v's bias correction."""
    bc1 = 1.0 - ref.ADAM_B1 ** step
    out = ([], [], [])
    for p, g, m_, v_ in zip(params, grads, m, v):
        m_ = ref.ADAM_B1 * m_ + (1 - ref.ADAM_B1) * g
        v_ = ref.ADAM_B2 * v_ + (1 - ref.ADAM_B2) * g * g
        out[0].append(p - lr * (m_ / bc1) / (torch.sqrt(v_) + ref.ADAM_EPS))
        out[1].append(m_)
        out[2].append(v_)
    return out


def double_lr(params, grads, m, v, step, lr):
    return ref.adam(params, grads, m, v, step, 2 * lr)


def train_cell(cell, seeds, controls, device) -> None:
    model = cell.config["model"]
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        prog = train_driver.Program(cell, seed, device)
        prog.warm()
        got, batches, before = prog.readings, prog.batches(), prog.before
        prog.release()
        del prog
        t1 = time.perf_counter()
        want = train_driver.reference_readings(cell, seed, device, batches,
                                               before)
        t2 = time.perf_counter()
        say(cell=cell.name, seed=seed, reading="program",
            **train_driver.numbers(got, want, cell),
            losses={k: got[k]["losses"] for k in got},
            ref_losses={k: want[k]["losses"] for k in want},
            program_s=t1 - t0, reference_s=t2 - t1,
            leaves=leaf_statistics(got, want, model))
        if i < controls:
            half = {k: [b[:b.shape[0] // 2] for b in v]
                    for k, v in batches.items()}
            other = dict(batches, replay=batches["start"]
                         * len(batches["replay"]))
            for name, kw, bat in (
                    ("control_fp8", {"prec": ref.CONTROL}, batches),
                    ("fault_half_batch", {}, half),
                    ("fault_double_lr", {"update": double_lr}, batches),
                    ("fault_no_v_correction", {"update": no_v_correction},
                     batches),
                    ("fault_other_rows", {}, other)):
                flt = train_driver.reference_readings(
                    cell, seed, device, bat, before, stated=False, **kw)
                say(cell=cell.name, seed=seed, reading=name,
                    **train_driver.numbers(flt, want, cell),
                    losses={k: flt[k]["losses"] for k in flt},
                    leaves=leaf_statistics(flt, want, model))
        torch.cuda.empty_cache()


def image_statistics(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The worst and the median image's error, the mean absolute pixel
    difference, and the share of pixels whose sign differs."""
    err = sample_driver.image_errors(got, want)
    return {"image_error": float(err.max()),
            "median_image_error": float(err.median()),
            "mean_abs": float((got.float() - want.float()).abs().mean()),
            "flips": float(((got > 0) != (want > 0)).float().mean()),
            "image_errors": err.tolist()}


def sample_cell(cell, seeds, controls, device) -> None:
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        prog = sample_driver.Program(cell, seed, device)
        prog.call()
        harness.synchronize(device)
        t1 = time.perf_counter()
        call, rows = sample_driver.checked(cell, seed, 1)
        got = prog.outputs[call][rows]
        del prog
        want = sample_driver.reference_images(cell, seed, device, call, rows)
        t2 = time.perf_counter()
        say(cell=cell.name, seed=seed, reading="program",
            **image_statistics(got, want), call_s=t1 - t0,
            reference_s=t2 - t1,
            saturated=float((want.abs() >= 1.0).float().mean()))
        if i < controls:
            ctl = sample_driver.reference_images(cell, seed, device, call,
                                                 rows, ref.CONTROL)
            say(cell=cell.name, seed=seed, reading="control_fp8",
                **image_statistics(ctl, want))
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    args = ap.parse_args()
    harness.cache_dirs()
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    device = harness.require_cards(cell.chips)[0]
    if cell.traffic["kind"] == "sample":
        sample_cell(cell, seeds, args.controls, device)
    else:
        train_cell(cell, seeds, args.controls, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
