"""The benchmark's own tests (`python -m pytest portbench/tests`): CPU
tests at tiny sizes, and tests marked `card`, which skip without a CUDA
device and run on the card."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_card():
    """Skips the test unless a CUDA device is there (decided when the
    test runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def checkout(tmp_path_factory):
    """A checkout of the program and the benchmark with the tiny cells."""
    from portbench.tests.helpers import make_checkout
    return make_checkout(str(tmp_path_factory.mktemp("checkout")))
