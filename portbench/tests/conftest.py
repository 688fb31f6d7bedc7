"""The benchmark's own tests (the repository's `pytest tests/` does not
collect them): `python -m pytest portbench/tests -q` from the repository's
root. Tests marked `cuda` need a CUDA card and skip themselves without one."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: test needs a CUDA card (skips itself without one)")
