"""Roofline share (%) of the block-sparse direct-space kernels K1-bs
(fixed_field_bs_kernel), K3-bs (scf_field_bs_kernel) and K2-bs
(direct_efp_bs_kernel), with the cluster_boxes_kernel pre-pass that K1-bs
and K2-bs launch, over one profiled report chunk: the sum of each launch's
bound (`block_bounds`, from the in-cutoff site pairs at the chunk's final
positions) over their summed device time. None where the trace holds none
of the three. Moves nve_ns_per_day.dense.

The bounds count what the function needs, whatever implements it, as
harness/roofline.dense_bounds does for K1/K2: each unordered in-cutoff
pair's chain once; the packed sites (8 floats a site) read once, and the
induced dipoles (3) by K3-bs and K2-bs; K1-bs writes the fixed field (3)
and one s3/s5 pair (2 floats) per in-cutoff pair, which K3-bs reads once
per launch and writes the dipole field (3); K2-bs writes its force,
potential and energy (5) once. Tiles, lines and the pairs of an active
tile pair outside the cutoff are the implementation's, not the work.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from port_bench.harness import roofline, trace  # noqa: E402
from port_bench.harness.roofline import OPS_K1, OPS_K2, OPS_TEST, TRANS_K1, TRANS_K2  # noqa: E402

KERNELS = ('fixed_field_bs_kernel', 'scf_field_bs_kernel', 'direct_efp_bs_kernel')
HELPERS = ('cluster_boxes_kernel',)

# operations per in-cutoff pair of one SCF dipole field (K3-bs): s3 and s5
# are given, so no cutoff test and no transcendental. The minimum-image
# difference: 3 subtractions, and per axis a multiply, a round and a fused
# multiply-add (2) = 15. Then for each of the pair's two sites, the other's
# dipole: mu . d (3 multiplies, 2 adds) = 5, s5 (mu . d) = 1, and per axis
# s3 mu_q + (s5 mu . d) d_q (a multiply and a fused multiply-add) added to
# the site's sum = 4, x 3 = 12: 18 a site, 36 the pair. 15 + 36 = 51.
OPS_K3 = 51
F32 = 4


def block_bounds(n_sites, n_in, rate):
    """{kernel: seconds per launch} of K1-bs, K3-bs and K2-bs on n_sites
    sites with n_in unordered in-cutoff pairs."""
    sites, vec, lines = n_sites * 8 * F32, n_sites * 3 * F32, n_in * 2 * F32
    return {'fixed_field_bs_kernel': roofline.bound_s(sites + vec + lines,
                                                      n_in * (OPS_TEST + OPS_K1),
                                                      n_in * TRANS_K1, rate),
            'scf_field_bs_kernel': roofline.bound_s(sites + vec + lines + vec, n_in * OPS_K3),
            'direct_efp_bs_kernel': roofline.bound_s(sites + vec + n_sites * 5 * F32,
                                                     n_in * (OPS_TEST + OPS_K2),
                                                     n_in * TRANS_K2, rate)}


def read(ctx):
    t, w = ctx.get('trace'), ctx.get('work')
    if not t or not w or not w['rate']:
        return None
    k = trace.kernel_group(t['kernels'], KERNELS + HELPERS)
    if not any(k[name][1] for name in KERNELS):
        return None
    return roofline.share(k, block_bounds(w['n_sites'], w['n_in'], w['rate']), HELPERS)
