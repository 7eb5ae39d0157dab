"""Device: the share of the traced window in which no kernel, copy or set
ran on the card (the union of the device's intervals over every stream),
in %."""


def read(trace, context, patterns):
    if context["steps_kind"] != "train" or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
