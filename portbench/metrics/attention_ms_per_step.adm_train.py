"""Model step: device time per ADM train step inside the multi-head
attention blocks, forward and backward, in ms: the device intervals that
start between a ``bla_mark_attention`` and the next
``bla_mark_attention_end`` (the program launches the pair around each
block's forward and, in the reverse order of its tensors, around its
backward), over the window's steps. None without the marks, or where they
do not pair up."""

import bisect
import re

START = re.compile(r"\bbla_mark_attention\b")
END = re.compile(r"\bbla_mark_attention_end\b")


def spans(trace):
    """(start, end) of every marked block, in order; None unless each
    start mark is followed by an end mark before the next start."""
    starts = sorted(a for name, a, _ in trace.device if START.search(name))
    ends = sorted(a for name, a, _ in trace.device if END.search(name))
    if not starts or len(starts) != len(ends):
        return None
    pairs = list(zip(starts, ends))
    if any(not a < b for a, b in pairs) or any(
            b > nxt for (_, b), (nxt, _) in zip(pairs, pairs[1:])):
        return None
    return pairs


def read(trace, context, patterns):
    if context["steps_kind"] != "train" or not trace.steps:
        return None
    pairs = spans(trace)
    if pairs is None:
        return None
    starts = [a for a, _ in pairs]
    total = 0.0
    for _, a, b in trace.device:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and a < pairs[i][1]:
            total += b - a
    return 1e3 * total / trace.steps
