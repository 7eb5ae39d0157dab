"""Debugging / validation utilities, the counterpart of
``big_linear_algebra_tpu/utils``: NaN checks on every op and kernel launch,
op-by-op execution, and a finite check of parameter trees."""

from big_linear_algebra_tpu_torch.utils.debug import (  # noqa: F401
    checked,
    debug_nans,
    no_jit,
    validate_finite,
)
