"""One torch thread while a port test file runs.

The suite runs in six pytest-xdist workers on the CPU, several of them
busy with torch at once.  torch's OpenMP threads, one a core in every
worker, then spin against each other: tests of 10-60 s alone took
500-1,600 s in a full run.  With one torch thread in each such file the
same tests take about their time alone (ROADMAP.md, test budget).

A test file takes it with `from .torch_threads import one_torch_thread`
and `pytestmark = pytest.mark.usefixtures("one_torch_thread")`.
"""

import pytest
import torch


@pytest.fixture(scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
