"""The benchmark's own CPU tests (``python -m pytest perfbench/tests``).

They import the harness from ``perfbench/`` and the port from ``src/``.
Tests marked ``cuda`` need a card and skip here; they decide inside the
``card`` fixture, never while a module is imported.
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card")
    return torch.device("cuda:0")
