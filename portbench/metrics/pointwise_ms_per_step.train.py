"""Model step: device time per train step of every kernel that is neither
the program's own, nor NCCL's, nor a library convolution or product:
GroupNorm, elementwise passes, reductions, copies, Philox draws and Adam,
in ms."""


def read(trace, context, patterns):
    if not trace.steps:
        return None
    ms = 1e3 * trace.device_s(patterns["include"], patterns["exclude"])
    return ms / trace.steps if ms > 0 else None
