"""Model step: device time per train step of the forward (the DDPM draws
and the loss), from the program's ``bla_mark_forward`` to its
``bla_mark_backward`` in each step (``phases.py``), in ms."""

from portbench import phases


def read(trace, context, patterns):
    if context["steps_kind"] != "train":
        return None
    return phases.ms_per_step(trace, "forward")
