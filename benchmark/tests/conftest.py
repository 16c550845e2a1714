"""The benchmark's CPU tests: ``python -m pytest -q benchmark/tests`` from the
repository's root.  They import no jax; tests that need the card carry the
``cuda`` marker and skip here."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def no_card():
    """Skip where a CUDA card is present: the test shows what a run does without one."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
