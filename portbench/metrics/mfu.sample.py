"""Device: the sampling's share of the card's bf16 peak, in %: the
model's operations (one forward an image a denoising step;
``yardstick.forward_flops``) of the traced window's steps, over
the chips' peak times the window."""

from portbench import yardstick

PASSES = 1


def read(trace, context, patterns):
    if context["steps_kind"] != "sample" or not trace.steps:
        return None
    model = context["cell"].config["model"]
    flops = (PASSES * trace.steps
             * yardstick.forward_flops(model, context["images_per_step"]))
    peak = yardstick.PEAK_FLOPS["bfloat16"] * context["chips"]
    return 100.0 * flops / (peak * trace.window_s)
