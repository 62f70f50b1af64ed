"""Share (%) of the dipole seeds of one profiled report chunk of the water256
cell that were the last health check's converged dipoles, taken again
instead of a second converged evaluation of the same state (the program's
counters dipole_seed_reuses / dipole_seeds, read as
harness/program_trace.py reads the others). None where the program counts
no seeds, as a program before the reuse does not. Moves
nve_ns_per_day.dense."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from port_bench.harness.program_trace import _counters  # noqa: E402


def read(ctx):
    c = _counters(ctx)
    if c is None or not c.get('dipole_seeds'):
        return None
    return 100.0 * c.get('dipole_seed_reuses', 0) / c['dipole_seeds']
