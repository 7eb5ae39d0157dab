"""Kernels: flash attention's share of its roofline in the ADM train step,
in %: the least time of every flash site's forward and whole backward
(``yardstick_adm.flash_bound_s`` at each site's (B·heads, N, d) at the
step's batch, in the configuration's compute dtype), over the device time
of the flash kernels (the patterns)."""

from portbench import yardstick_adm


def read(trace, context, patterns):
    model = context["cell"].config["model"]
    sites = yardstick_adm.flash_sites(model, context["images_per_step"])
    spent = trace.device_s(patterns["include"], patterns["exclude"])
    if not sites or spent <= 0 or not trace.steps:
        return None
    least = sum(yardstick_adm.flash_bound_s(k, bh, n, d,
                                            model["compute_dtype"])
                for bh, n, d in sites for k in ("fwd", "bwd"))
    return 100.0 * least * trace.steps / spent
