"""Dispatch: the host's time per sampling call in building its CUDA graph,
the union of the program's spans ``bla.graph.warmup`` (the eager steps
before the capture), ``bla.graph.gc`` and ``bla.graph.capture``, over the
``bla.sample`` spans in the window, in ms."""

from portbench import phases

SPANS = ("bla.graph.warmup", "bla.graph.gc", "bla.graph.capture")


def read(trace, context, patterns):
    calls = phases.spans(trace, ("bla.sample",))
    if context["steps_kind"] != "sample" or not calls:
        return None
    covered = sum(b - a for a, b in phases.merged(phases.spans(trace,
                                                               SPANS)))
    return 1e3 * covered / len(calls)
