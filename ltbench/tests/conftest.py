"""The benchmark's own tests: ``python3 -m pytest ltbench/tests`` from the
repository's root.  A test that needs a CUDA card is marked ``card`` and
skips where there is none; ``python3 -m pytest ltbench/tests -m card`` on
a machine with a card runs them."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.fixture
def at_root(monkeypatch):
    """Run from the repository's root, where BENCHMARK.json is."""
    monkeypatch.chdir(ROOT)
    from ltbench import run

    monkeypatch.setattr(run, "ROOT", ROOT)
    return ROOT
