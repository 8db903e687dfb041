"""Tests of the benchmark: ``python -m pytest benchmark/tests -q`` from the
repository root (on the CPU, with the program's plain versions at small
sizes; tests marked ``chip`` run only where a CUDA card is)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, at run time)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100")
    return torch.cuda.get_device_name(0)


@pytest.fixture(autouse=True)
def few_threads():
    """The program's plain versions on few threads: the tests run beside
    others."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)
