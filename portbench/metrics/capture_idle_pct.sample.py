"""Device: the share of the traced window in which the card is idle while
the program prepares a sampling call or builds its graph (one of the
spans ``bla.sample.prepare``, ``bla.graph.warmup``, ``bla.graph.gc``,
``bla.graph.capture`` is open), in %."""

from portbench import phases

SPANS = ("bla.sample.prepare", "bla.graph.warmup", "bla.graph.gc",
         "bla.graph.capture")


def read(trace, context, patterns):
    if (context["steps_kind"] != "sample" or trace.window_s <= 0
            or not phases.spans(trace, ("bla.sample",))):
        return None
    return 100.0 * phases.idle_under_s(trace, SPANS) / trace.window_s
