"""The program's own marks and spans in a traced window: the phase of each
device interval, and the time under named host spans.

- A mark is a device event ``bla_mark_<phase>`` (forward, backward, adam,
  update), an empty kernel the program launches where a phase of a step
  starts, captured into its CUDA graphs. Every device interval that
  starts at or after a mark belongs to the phase of the latest mark before
  it, whatever its stream; one that starts before the first mark belongs
  to none. Marks and intervals are taken from the whole trace, not cut at
  the window's end: the traced body is the window alone, and the card's
  clock, as the profiler maps it onto the host's, can place the last few
  ms of a long window's device work past the host's end of it (on an H100
  the last 2-3 steps of a 4.2 s sampling call, in one run of three).
- A span is a host event (``user_annotation``) named ``bla.<layer>.<what>``
  by the program, on the clock of the device events.

A program without marks or spans gives the readers nothing to read: they
return None.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, Iterable, List, Tuple

from portbench import yardstick

MARK = re.compile(r"\bbla_mark_(forward|backward|adam|update)\b")
Intervals = List[Tuple[float, float]]


def marks(trace) -> List[Tuple[float, str]]:
    """(start, phase) of every mark, in order."""
    return sorted((a, m.group(1)) for name, a, _ in trace.device
                  for m in [MARK.search(name)] if m)


def phase_s(trace, found=None) -> Dict[str, float]:
    """Each phase's device seconds: the summed intervals that belong to
    it."""
    found = marks(trace) if found is None else found
    starts = [a for a, _ in found]
    out: Dict[str, float] = {}
    for _, a, b in trace.device:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0:
            phase = found[i][1]
            out[phase] = out.get(phase, 0.0) + (b - a)
    return out


def ms_per_step(trace, phase: str):
    """``phase``'s device time a step in ms: its seconds over the forward
    marks (one a step). None unless those marks are as many as the
    window's steps (``trace.steps``) and ``phase`` has a mark."""
    found = marks(trace)
    steps = sum(1 for _, p in found if p == "forward")
    if not steps or steps != trace.steps or all(p != phase
                                                for _, p in found):
        return None
    return 1e3 * phase_s(trace, found).get(phase, 0.0) / steps


def spans(trace, names: Iterable[str]) -> Intervals:
    """The host spans named one of ``names`` that start inside the window,
    clipped to it."""
    names = set(names)
    return [(a, min(b, trace.hi)) for name, a, b in trace.host
            if name in names and trace.lo <= a <= trace.hi]


def merged(intervals: Intervals) -> Intervals:
    """The union of ``intervals`` as disjoint intervals, in order."""
    out: Intervals = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def overlap_s(xs: Intervals, ys: Intervals) -> float:
    """The length of the intersection of two unions of intervals."""
    xs, ys = merged(xs), merged(ys)
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_under_s(trace, names: Iterable[str]) -> float:
    """Seconds of the window in which the card is idle (no device
    interval on any stream) and a span of ``names`` is open."""
    idle = yardstick.gaps(trace.clipped(), trace.lo, trace.hi)
    return overlap_s(idle, spans(trace, names))
