"""Share (%) of one profiled report chunk's span that the host spends at the
report edges of the water256 cell: the program's spans md.simulation.dipole_seed,
md.simulation.readback and md.simulation.health_check, summed
(harness/program_trace.py). Moves nve_ns_per_day.dense."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from port_bench.harness.program_trace import edge_host_share as read  # noqa: E402,F401
