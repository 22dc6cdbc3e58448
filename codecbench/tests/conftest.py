"""Test settings of the benchmark's own tests:

    python -m pytest codecbench/tests -q

CPU tests run anywhere; tests marked `cuda` need a card and skip without
one (on the card: the same command)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skipped where there is none)")
