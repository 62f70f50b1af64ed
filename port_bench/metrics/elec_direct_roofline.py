"""Roofline share (%) of the dense direct-space kernels K1
(fixed_field_tri_kernel) and K2 (direct_efp_tri_kernel), with the
tile_sum_kernel they launch, over one profiled report chunk: the sum of
each launch's bound (harness/roofline.dense_bounds, from the in-cutoff
site pairs at the chunk's final positions) over their summed device time.
Moves nve_ns_per_day.dense."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from port_bench.harness import roofline, trace  # noqa: E402

KERNELS = ('fixed_field_tri_kernel', 'direct_efp_tri_kernel')
HELPERS = ('tile_sum_kernel',)


def read(ctx):
    t, w = ctx.get('trace'), ctx.get('work')
    if not t or not w or not w['rate']:
        return None
    k = trace.kernel_group(t['kernels'], KERNELS + HELPERS)
    if not all(k[name][1] for name in KERNELS):
        return None
    return roofline.share(k, roofline.dense_bounds(w['n_sites'], w['n_in'], w['rate']), HELPERS)
