"""Kernels: the fused resnet blocks' share of their roofline in a train
step, in %: the least time of every fused block's forward and whole
backward (``yardstick.k5_bound_s`` at each block the program fuses at the
step's batch, in bf16), over the device time of the kernels that compute
them."""

from portbench import reference, yardstick


def read(trace, context, patterns):
    model = context["cell"].config["model"]
    b = context["images_per_step"]
    sites = reference.fused_sites(model, b)
    spent = trace.device_s(patterns["include"], patterns["exclude"])
    if not sites or spent <= 0 or not trace.steps:
        return None
    least = sum(yardstick.k5_bound_s(k, b, cin, cout, h, h,
                                     model["compute_dtype"])
                for _, cin, cout, h in sites for k in ("fwd", "bwd"))
    return 100.0 * least * trace.steps / spent
