"""Model step: device time per train step of the backward (the gradient
and the zeros of unused leaves), from the program's ``bla_mark_backward``
to its ``bla_mark_adam`` in each step (``phases.py``), in ms."""

from portbench import phases


def read(trace, context, patterns):
    if context["steps_kind"] != "train":
        return None
    return phases.ms_per_step(trace, "backward")
