"""Host seconds of the set-up's first converged evaluation (the program's
phase md.simulation.set_positions, first; harness/program_trace.py). Moves
setup_s."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from port_bench.harness.program_trace import setup_first_eval_s as read  # noqa: E402,F401
