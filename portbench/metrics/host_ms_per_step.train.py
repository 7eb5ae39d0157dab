"""Dispatch: the host's time a step in one call into the train entry
(``TrainSteps.run``, 32 steps of replays), timed by the benchmark's clock
from an idle device, in ms: what the host spends dispatching a step,
apart from the device's time."""


def read(trace, context, patterns):
    if context["steps_kind"] != "train" or "host_s_per_step" not in context:
        return None
    return 1e3 * context["host_s_per_step"]
