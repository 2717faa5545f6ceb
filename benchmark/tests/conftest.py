"""Fixtures of the benchmark's own tests (run: python -m pytest benchmark/tests -q).

They run on the CPU at small sizes: the drivers run the port's plain kernel
versions there. Tests marked `card` need a CUDA device and skip without one
(decided inside the `card` fixture, never at import).
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (runs on the chip)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the chip")

