"""Sum the device and host time in a ``torch.profiler`` Chrome trace.

    python -m big_linear_algebra_tpu_torch.models.mnist_nn run --profile=DIR
    python3 trace_summary.py DIR/trace.json [--top N]

Of the trace's complete events (``"ph": "X"``), it prints
- the span: first start to last end, over every event;
- device busy: the summed durations of the ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset`` events, and their share of the span (they do not overlap
  on one stream, which is all the port uses);
- the ``--top`` device entries by (category, name), summed;
- the ``--top`` host entries: ``cpu_op``, ``python_function`` and
  ``user_annotation`` events summed by name. Host ops nest, so these sums
  overlap one another and are not a breakdown of the span.
"""

from __future__ import annotations

import argparse
import collections
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "python_function", "user_annotation")


def device_by_name(trace: dict) -> dict:
    """{name: summed µs} of the trace's device events (``DEVICE_CATS``)."""
    out = collections.defaultdict(float)
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            out[e["name"]] += e["dur"]
    return dict(out)


def summarize(trace: dict, top: int) -> str:
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    t0 = min(e["ts"] for e in ev)
    t1 = max(e["ts"] + e["dur"] for e in ev)
    device = collections.defaultdict(float)
    host = collections.defaultdict(float)
    for e in ev:
        if e.get("cat") in DEVICE_CATS:
            device[(e["cat"], e["name"][:80])] += e["dur"]
        elif e.get("cat") in HOST_CATS:
            host[e["name"][:80]] += e["dur"]
    busy = sum(device.values())
    lines = [f"trace span {(t1 - t0) / 1e3:.3f} ms",
             f"device busy {busy / 1e3:.3f} ms = "
             f"{100 * busy / (t1 - t0):.3f}% of the span"]
    for (cat, name), us in sorted(device.items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"  device {us:10.1f} us  {cat}  {name}")
    for name, us in sorted(host.items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"  host {us / 1e3:10.3f} ms  {name}")
    return "\n".join(lines)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace", help="trace.json written by --profile")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    with open(args.trace) as f:
        print(summarize(json.load(f), args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
