"""The benchmark's own tests: `python -m pytest benchmark/tests -q` from the
root of the repo (the repo's `pytest tests/` does not collect them).  Tests
marked ``cuda`` decide inside the test whether a card exists."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (runs the hand-written kernels); skipped without one")
