"""Shared helpers for the PyTorch port's parity tests.

The same numpy inputs, made from a seed, go to a JAX function and to its
counterpart in the port; outputs come back as numpy for comparison. Importing
this module caps torch at one thread, so parallel test workers do not
oversubscribe the host.
"""

import numpy as np
import torch

torch.set_num_threads(1)


def card() -> torch.device:
    """The NVIDIA card, for a test marked ``card``; skips where CUDA is not
    available. Called inside the test, so every worker collects the same
    tests. The card's machine has no JAX: there the card tests run from
    the files that import none, with ``-m card --noconftest``."""
    if not torch.cuda.is_available():
        import pytest

        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda", 0)


def t(x, dtype=None) -> torch.Tensor:
    """numpy → CPU tensor (copied: arrays from JAX are read-only)."""
    out = torch.from_numpy(np.array(x, copy=True))
    return out if dtype is None else out.to(dtype)


def n(x) -> np.ndarray:
    """tensor or JAX array → float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def as_variant(a64, b64, variant):
    """Stored operands of ``variant`` for the product ``a64 @ b64``."""
    if variant == "nt":
        return a64, b64.T.copy()
    if variant == "tn":
        return a64.T.copy(), b64
    return a64, b64
