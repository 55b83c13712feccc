"""Settings of the benchmark's own tests (run: python -m pytest
perfbench/tests). Tests that need an NVIDIA card carry the `cuda` marker
and skip without one; each decides in the `card` fixture, never while
the module is imported."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
