"""Device: the ADM train step's share of the card's bf16 peak, in %: the
model's operations (three forwards an image: forward and backward, no
recompute; ``yardstick_adm.adm_forward_flops``) of the traced window's
steps, over the chips' peak times the window."""

from portbench import yardstick, yardstick_adm

PASSES = 3


def read(trace, context, patterns):
    if context["steps_kind"] != "train" or not trace.steps:
        return None
    model = context["cell"].config["model"]
    flops = (PASSES * trace.steps * yardstick_adm.adm_forward_flops(
        model, context["images_per_step"]))
    peak = yardstick.PEAK_FLOPS["bfloat16"] * context["chips"]
    return 100.0 * flops / (peak * trace.window_s)
