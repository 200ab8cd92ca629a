"""CPU tests of the benchmark harness (``python -m pytest port_bench/tests``).

Tests that need a CUDA card carry the ``cuda`` marker and skip without one;
whether there is a card is decided in the ``cuda_card`` fixture, never
while a module is imported.
"""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's runs need one")


@pytest.fixture(autouse=True)
def one_torch_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
