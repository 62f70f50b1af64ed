"""Host seconds of the set-up's first eager step at a box and its capture into
a CUDA graph (the program's phases md.step_graph.eager_step and
md.step_graph.capture, first of each; harness/program_trace.py). Moves
setup_s."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from port_bench.harness.program_trace import setup_capture_s as read  # noqa: E402,F401
