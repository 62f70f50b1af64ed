"""Acceptance checks of the fused PIP kernels of ops/pip_fused.py against
their plain twins, shared by chip_smoke.py and
tests/test_torch_kernels_cuda.py.

For each kernel and polynomial, on one batch of variables x [P, V]:

  rel   max |kernel - twin| / max |twin| over the rows, for the energies e
        and for the gradients g, kernel and twin both float32. The kernel
        and the twin do the same arithmetic in another order (the twin's
        products are library GEMMs, its sums pairwise), so they agree to a
        few float32 roundings of the largest intermediate. On seeded rows
        uniform in [1e-4, 1] that is REL = 2e-5 of the largest output
        (readings <= 3.4e-7). On the variables of a water box (`physical`)
        the outputs are what is left after the fits cancel over three
        orders of magnitude (max |e| ~ 7-17 kcal/mol from terms of ~1e3):
        there the plain float32 twin itself sits 2.4e-3 to 5.3e-3 (e) and
        3.3e-5 to 1.55e-4 (g) of the max from its float64 run, every impl
        alike (water256, NVIDIA H100 80GB HBM3, 700.00 W), so 2e-5 cannot
        hold and the bounds are the fixed REL_PHYS = 2 x the largest of
        those readings (kernel against twin reads <= 2.0e-3 and 6.4e-5).
  acc   the kernel's error against the float64 twin is at most ACC_FACTOR
        times the float32 twin's own, plus ACC_FLOOR of the max: the kernel
        is no less accurate than the plain float32 evaluation.
  finite  every output finite.

On seeded rows a 1% error in one row's energy, or in one gradient entry,
fails `rel` whenever that entry is above REL / 1% = 0.2% of the batch's
largest (tests/test_torch_pip.py); the kernels take no branch on the data,
so the loose bounds on physical variables guard the cancellation, not the
indexing.
"""
from __future__ import annotations

import torch

from mbpol_openmm_plugin_tpu_torch.ops.elec_direct_check import Row, _acc, _rel

REL = 2e-5
REL_PHYS = {'e': 1e-2, 'g': 3e-4}
ACC_FACTOR, ACC_FLOOR = 2.0, 1e-6     # as ops/elec_direct_check.py


def pip_rows(kern, twin, twin64, physical=False):
    """Rows of one check: kern/twin/twin64 = (e [P], g [P, V]) of the
    kernel, the float32 twin and the float64 twin on the same variables;
    `physical`: the variables are a water box's (REL_PHYS), not seeded."""
    rows = []
    for output, k, t, t64 in zip(('e', 'g'), kern, twin, twin64):
        rows.append(Row(output, 'all rows', 'rel', _rel(k, t),
                        REL_PHYS[output] if physical else REL))
        rows.append(Row(output, 'all rows', 'acc', _acc(k, t, t64), 1.0))
        if not bool(torch.isfinite(k).all()):
            rows.append(Row(output, 'all rows', 'finite', float('inf'), 0.0))
    return rows


def kernel_rows(wrapper, name, x, physical=False):
    """Run one wrapper of ops/pip_fused.py on x [P, V] (the kernel, for a
    CUDA float32 tensor) and its twin in float32 and float64, and check
    them (`physical` as in `pip_rows`). Returns (rows, max |kernel - twin|
    over e and g)."""
    from mbpol_openmm_plugin_tpu_torch.ops import pip_fused
    plain = pip_fused.PLAIN[wrapper]
    kern = wrapper(name, x)
    twin = plain(name, x)
    twin64 = plain(name, x.double())
    max_abs = max(float((k - t).abs().max()) for k, t in zip(kern, twin))
    return pip_rows(kern, twin, twin64, physical), max_abs
