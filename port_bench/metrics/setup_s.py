"""Set-up seconds of every cell (harness/readers.py)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from port_bench.harness.readers import setup_s as read  # noqa: E402,F401
