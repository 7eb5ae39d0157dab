"""The readings that the ADM cell's limits are set from, on the card, in
one process (``calibrate.py``'s protocol): for each seed the program's
numbers against the reference (the lower reading is their largest), and on
the first ``--controls`` seeds the control's (the reference in float8, put
in the program's place) and each fault of ``reference_adm.FAULTS`` planted
in the reference, put in the program's place (the upper reading is the
smallest that fails):

    python3 portbench/calibrate_adm.py --workload adm_imagenet64.train_b128 \
        --seeds 1,2,3 [--controls 1]

Prints one JSON line per reading, with the five leaves of largest gradient
gap.
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
from portbench import reference_adm as ref  # noqa: E402
from portbench.drivers import train_adm  # noqa: E402
from portbench.drivers.train import leaf_gaps  # noqa: E402


def say(**kw) -> None:
    print(json.dumps(kw), flush=True)


def worst_leaves(got: dict, want: dict, model: dict) -> list:
    paths = ref.leaf_paths(model)
    w, g = want["start"]["grad"], got["start"]["grad"]
    gaps = leaf_gaps(g, w, [i for i, x in enumerate(w) if x.any()])
    return [[paths[i], gaps[i]] for i in sorted(gaps, key=gaps.get,
                                                reverse=True)[:5]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=1)
    args = ap.parse_args()
    harness.cache_dirs()
    cell = harness.load_cell(args.workload)
    device = harness.require_cards(cell.chips)[0]
    model = cell.config["model"]
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        prog = train_adm.Program(cell, seed, device)
        prog.warm()
        peak = torch.cuda.max_memory_allocated(device)
        got, batches, before = prog.readings, prog.batches(), prog.before
        prog.release()
        del prog
        t1 = time.perf_counter()
        want = train_adm.reference_readings(cell, seed, device, batches,
                                            before)
        t2 = time.perf_counter()
        say(cell=cell.name, seed=seed, reading="program",
            **train_adm.numbers(got, want, cell),
            losses={k: got[k]["losses"] for k in got},
            ref_losses={k: want[k]["losses"] for k in want},
            program_s=t1 - t0, reference_s=t2 - t1, memory_peak_bytes=peak,
            worst=worst_leaves(got, want, model))
        if i >= args.controls:
            continue
        for name, kw in [("control_fp8", {"prec": ref.CONTROL})] + [
                (f"fault_{f}", {"fault": f}) for f in ref.FAULTS]:
            flt = train_adm.reference_readings(cell, seed, device, batches,
                                               before, stated=False, **kw)
            say(cell=cell.name, seed=seed, reading=name,
                **train_adm.numbers(flt, want, cell),
                losses={k: flt[k]["losses"] for k in flt},
                worst=worst_leaves(flt, want, model))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
