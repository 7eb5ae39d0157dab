"""The benchmark's own tests. Those that need the card carry the ``card``
marker and skip, with their reason, where CUDA is not available; whether
it is is decided inside the test (the ``card`` fixture), never when a
module is imported.

    python -m pytest portbench/tests -q            # here: the CPU tests
    python -m pytest portbench/tests -q -m card    # on the card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without CUDA)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda", 0)
