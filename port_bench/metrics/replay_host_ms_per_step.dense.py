"""Host ms in the program's md.step_graph.replay spans (one CUDA graph
replay each) per step of one profiled report chunk of the water256 cell
(harness/program_trace.py). Moves nve_ns_per_day.dense."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from port_bench.harness.program_trace import replay_host_ms_per_step as read  # noqa: E402,F401
