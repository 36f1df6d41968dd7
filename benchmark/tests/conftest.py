"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.  Tests
marked ``card`` need a CUDA card and skip without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU build")
    return torch.device("cuda")


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    """Small models on the CPU: one thread each, so that parallel test
    workers do not starve each other's timed windows."""
    import torch

    torch.set_num_threads(1)
