"""Share (%) of one profiled report chunk's span that the host spends in
the program's converged evaluations (the chunk-start and health-check
evaluations, the report edges): the benchmark's spans
'models.potential.converged_eval' around MBPol's evaluation, summed, over
the chunk's span. Moves nve_ns_per_day.dense."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

SPAN = 'models.potential.converged_eval'


def read(ctx):
    t = ctx.get('trace')
    if not t or not t.get('span_s', {}).get(SPAN) or not t.get('window_s'):
        return None
    return 100.0 * t['span_s'][SPAN] / t['window_s']
