"""The harness's tests: on the CPU here; those marked `cuda` need a card
and skip without one (decided inside the `cuda_card` fixture)."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path[:] = [BENCH, ROOT] + [p for p in sys.path if p not in (BENCH, ROOT)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where there is none")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread while a test runs (spinning OpenMP threads of
    several test workers slow each other many times over)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
