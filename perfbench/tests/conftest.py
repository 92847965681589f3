"""The benchmark's own tests: ``python -m pytest perfbench/tests -q``.

Tests marked ``card`` need a CUDA device; each decides inside the test
whether one is there and skips otherwise."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")
