"""Simulated ns per day of the NVE cells on the dense electrostatics path
(water256: ~3,600 small kernels a step, close to the host's launch rate;
harness/readers.py)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from port_bench.harness.readers import ns_per_day as read  # noqa: E402,F401
