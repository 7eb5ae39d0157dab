"""Model step: device time per denoising step of the DDPM update (the
draw of z, the ancestral step written into x, the timestep counted down),
from the program's ``bla_mark_update`` to the next step's
``bla_mark_forward`` (``phases.py``), in ms."""

from portbench import phases


def read(trace, context, patterns):
    if context["steps_kind"] != "sample":
        return None
    return phases.ms_per_step(trace, "update")
