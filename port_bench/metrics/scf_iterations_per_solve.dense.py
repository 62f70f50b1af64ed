"""SOR iterations per converged solve (the program's counters
scf_iterations / scf_solves) in one profiled report chunk of the water256
cell (harness/program_trace.py). Moves nve_ns_per_day.dense."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from port_bench.harness.program_trace import scf_iterations_per_solve as read  # noqa: E402,F401
