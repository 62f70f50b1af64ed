"""Reads of device values on the host (the program's counter host_reads) in
one profiled report chunk of the water256 cell (harness/program_trace.py).
Moves nve_ns_per_day.dense."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from port_bench.harness.program_trace import host_reads_per_chunk as read  # noqa: E402,F401
