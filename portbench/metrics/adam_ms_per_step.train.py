"""Model step: device time per train step of Adam (the update, its copy
back into the step's buffers, the loss recorded, and the next step's batch
gathered), from the program's ``bla_mark_adam`` to the next step's
``bla_mark_forward`` (``phases.py``), in ms."""

from portbench import phases


def read(trace, context, patterns):
    if context["steps_kind"] != "train":
        return None
    return phases.ms_per_step(trace, "adam")
