"""The `card` marker and fixture: a test that needs a CUDA device asks
for `card`, which skips it where there is none (decided inside the test,
never at import), and a thread cap for the CPU tests."""

from __future__ import annotations

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skipped where there is none")


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
