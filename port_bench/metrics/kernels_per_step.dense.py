"""`kernels_per_step` of one profiled report chunk in the water256 cell (dense electrostatics, K1/K2)
(harness/readers.py). Moves nve_ns_per_day.dense."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from port_bench.harness.readers import kernels_per_step as read  # noqa: E402,F401
