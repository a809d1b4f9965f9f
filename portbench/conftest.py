"""pytest settings of the benchmark's own tests (``pytest portbench/tests``).

``card`` marks a test that needs an NVIDIA card; whether one is there is
decided inside the ``card`` fixture when the test runs, never at import."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the card only")
    return torch.device("cuda")
