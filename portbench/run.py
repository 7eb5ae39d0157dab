"""Run one cell of the benchmark once, on the card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. ``--trace 0`` measures the cell's end-to-end
metrics over a window of ``--seconds``; ``--trace 1`` profiles a short
window and reads the cell's per-layer metrics. Either way the output of
the timed path is compared with the plain reference afterwards. The last
line of standard output is the result (JSON); the numbers compared, each
beside its limit, are the last lines of standard error. Without a card, or
with fewer than the cell asks for, it prints no result and exits with 2;
with a forbidden module loaded (``harness.FORBIDDEN``), with 3.
"""

from __future__ import annotations

import argparse
import importlib
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(cell: harness.Cell, seed: int, seconds: float, trace: bool,
            devices, t_start: float):
    """(result line, compared lines) of one run of ``cell``."""
    driver = importlib.import_module(
        f"portbench.drivers.{cell.traffic['kind']}")
    out = driver.run(cell, seed, seconds, trace, devices, t_start)
    device, breakdown = out["device"], None
    if trace:
        tr = out["trace"]
        metrics = harness.read_metrics(cell, tr,
                                       dict(out["context"], cell=cell))
        device.update(busy_s=tr.busy_s(),
                      window_s=tr.window_s)
        breakdown = tr.breakdown()
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end()}
    check = out["check"]
    lines = [f"compared {k}: {v['value']!r} limit {v['limit']!r}"
             for k, v in check.summary().items()]
    return harness.result_line(check, out["attempted"], metrics, device,
                               breakdown), lines


def main(argv=None) -> int:
    t_start = harness.process_start()
    args = parse(sys.argv[1:] if argv is None else argv)
    harness.cache_dirs()
    try:
        cell = harness.load_cell(args.workload)
        devices = harness.require_cards(cell.chips)
        line, compared = measure(cell, args.seed, args.seconds,
                                 bool(args.trace), devices, t_start)
    except harness.NoResult as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print("no result: forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    print("\n".join(compared), file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
