"""Dispatch: the host's time a denoising step in one call into the
sampling entry (``sample``: its capture, then replays), timed by the
benchmark's clock from an idle device, in ms."""


def read(trace, context, patterns):
    if context["steps_kind"] != "sample" or "host_s_per_step" not in context:
        return None
    return 1e3 * context["host_s_per_step"]
