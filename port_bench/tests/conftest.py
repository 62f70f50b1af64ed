"""The benchmark's own tests (run with `python -m pytest port_bench/tests`).
Tests that need a CUDA card carry the `cuda` marker and decide inside
themselves whether a card is there; the rest run on the CPU."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line('markers', 'cuda: needs a CUDA card; skips without one')
