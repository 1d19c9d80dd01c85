"""The benchmark's tests: CPU tests at small sizes, and tests marked
``card`` that need a CUDA card and skip without one (decided inside the
test).  Run them with ``python -m pytest benchmark`` from the root of the
repository; ``-m card`` on a machine with a card runs those alone."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _few_threads():
    """Small CPU frames run on two threads: the machine is shared."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    """The first CUDA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
