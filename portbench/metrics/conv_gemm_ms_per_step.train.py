"""Model step: device time per train step of the library's convolution and
matrix-product kernels (cuDNN, cuBLAS, CUTLASS names in the patterns), in
ms."""


def read(trace, context, patterns):
    if not trace.steps:
        return None
    ms = 1e3 * trace.device_s(patterns["include"], patterns["exclude"])
    return ms / trace.steps if ms > 0 else None
