"""The two dense direct-space kernels of csrc/elec_direct.cu alone, on one
CUDA card, at water256 (the fixture, 1,024 sites) and water2048 (the
fixture repeated 2 x 2 x 2, 8,192 sites, in the dense mode): a short
build-check-time run (chip_smoke.py phase 3 holds them too).

    python -m mbpol_openmm_plugin_tpu_torch.tools.dense_probe [--waters 256 2048] [--reps 20]

Builds the kernels and prints the compiler's resource lines of K1, K2 and
the tile-sum kernel. Then, per size: calls K1 and K2 twice each right
after freeing NaN-filled tensors of their outputs' sizes (the caching
allocator hands the same memory back), and checks that every output is
finite (every entry written), that the two calls give the same bits and
that s3 and s5 are exactly symmetric with a zero diagonal; checks each
kernel against its plain twins (the triangular twins, float32 and
float64) on the entry sets of ops/elec_direct_check.py; prints a SHA-256
of each kernel's outputs; and times each kernel per launch: torch.profiler
device time of the kernel and the tile sum it launches (and of every
kernel in the trace), divided by the kernel's launches in the trace, and
back to back between CUDA events, beside the device time of an empty
kernel launch (the card's floor per launch) and the kernel's bound
(`dense_bounds`, as chip_smoke.py phase 3 computes it). K2 takes dipoles
of realistic size: polarity times K1's field. Exits non-zero when a check
fails or a device time reads below its bound (a miscount, not a speed).
Prints the card's name and power limit and one JSON object as the last
line.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch.tools.timing import (bound, card_line, kernel_device_ms,
                                                        loop_ms, transcendental_rate)

BOX = 19.3996888399961804 / 10.0
CUTOFF = 0.9
REPS = {256: (1, 1, 1), 2048: (2, 2, 2)}
KERNEL_NAMES = {'fixed_field_and_scf_factors': 'fixed_field_tri_kernel',
                'direct_energy_force_pot': 'direct_efp_tri_kernel'}
HELPER = 'tile_sum_kernel'
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), 'tests', 'fixtures', 'water256_integration_test.npz')


# operations per site pair, each arithmetic operation or transcendental
# counted once: the cutoff test (3 differences, minimum image, r^2, sqrt,
# compare) and the rest of the chain (K1, K2). A bound charges them to the
# pairs the function needs on this run's inputs, the in-cutoff ones,
# whatever the route visits. The transcendentals of the chain per in-cutoff
# pair (sqrtf, 1/r, erfcf, and the chain's expf calls: 3 in K1's, 4 in
# K2's) go to the transcendental unit (timing.transcendental_rate).
OPS_TEST, OPS_K1, OPS_K2 = 25, 60, 150
TRANS_K1, TRANS_K2 = 6, 7


def dense_bounds(n, n_in, rate):
    """{wrapper name: bound(...)} of K1 and K2 on n sites with n_in unordered
    in-cutoff pairs: the chain of each such pair once, the packed sites and
    the dipoles read once, the outputs (K1's whole s3/s5) written once."""
    return {'fixed_field_and_scf_factors': bound(n * 32 + n * 12 + 2 * n * n * 4,
                                                 n_in * (OPS_TEST + OPS_K1),
                                                 n_transcendental=n_in * TRANS_K1,
                                                 transcendental_rate=rate),
            'direct_energy_force_pot': bound(n * 32 + n * 12 + n * 20,
                                             n_in * (OPS_TEST + OPS_K2),
                                             n_transcendental=n_in * TRANS_K2,
                                             transcendental_rate=rate)}


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def dense_inputs(reps, device='cuda'):
    """(packed sites [N, 8], polarity [N], DirectConsts) of the water256
    fixture repeated reps = (nx, ny, nz) times, float32, on device, as the
    dense branch of models/pme builds them (PME at the 0.9 nm cutoff)."""
    from mbpol_openmm_plugin_tpu_torch.models import electrostatics as elec
    from mbpol_openmm_plugin_tpu_torch.models.pme import PmeSetup
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
    from mbpol_openmm_plugin_tpu_torch.system import (System, compute_virtual_sites,
                                                      make_molecules_whole, replicate)
    with np.load(FIXTURE) as z:
        system = System.from_atom_names(z['names'], z['resnames'], box=[BOX] * 3)
        pos = torch.as_tensor(np.array(z['positions']), dtype=torch.float32, device=device)
    pos = compute_virtual_sites(system, make_molecules_whole(system, pos))
    if tuple(reps) != (1, 1, 1):
        system, pos = replicate(system, pos, reps)
        pos = compute_virtual_sites(system, pos)
    params = elec.ElecParams.for_system(system)
    setup = PmeSetup.from_config(system, MBPolConfig(nonbonded_method='PME', cutoff=CUTOFF))
    charges, _ = elec.assemble_charges(params, pos)
    d16 = torch.as_tensor(np.asarray(params.damping) ** (-1.0 / 6.0), dtype=pos.dtype,
                          device=device)
    sites = ED.pack_sites(pos, charges, d16, torch.as_tensor(params.mol_index, device=device),
                          torch.as_tensor(params.atom_type == 0, device=device))
    polarity = torch.as_tensor(params.polarity, dtype=pos.dtype, device=device)
    return sites, polarity, ED.DirectConsts.from_setup(setup, params.thole)


def resource_lines(build_log):
    lines, keep = [], False
    for line in build_log.splitlines():
        if 'Compiling entry function' in line:
            keep = (('fixed_field_' in line or 'direct_efp_' in line or HELPER in line)
                    and '_bs_' not in line)
        if keep and any(w in line for w in ('Compiling', 'registers', 'spill')):
            lines.append(line.strip())
    return lines


def scratch_shapes(n, k):
    """The partials scratch [n_tiles, k, n] of the kernels' wrappers."""
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
    return [(-(-n // ED.TILE), k, n)]


def written_twice(call, shapes):
    """Two calls, each right after NaN-filled tensors of `shapes` (the
    wrapper's outputs and scratch, in its order) are freed; (outputs of
    the first call, its outputs all finite, the two calls equal bit for
    bit)."""
    outs = []
    for _ in range(2):
        junk = [torch.full(s, float('nan'), device='cuda') for s in shapes]
        del junk
        outs.append(call())
        torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(t).all()) for t in outs[0])
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    return outs[0], finite, same


def probe_size(waters, args, card, rate, failures):
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_check as check

    sites, polarity, consts = dense_inputs(REPS[waters])
    n = sites.shape[0]
    tag = f'water{waters}'
    print(f'{tag}: sites {tuple(sites.shape)}, cutoff {consts.cutoff} nm', flush=True)
    out = {}

    k1, finite, same = written_twice(lambda: ED.fixed_field_and_scf_factors(sites, consts),
                                     [(n, 3), (n, n), (n, n)] + scratch_shapes(n, 3))
    sym = all(bool(torch.equal(s, s.T)) and not bool(s.diagonal().any()) for s in k1[1:])
    n_in = int(((k1[1] != 0) | (k1[2] != 0)).sum())
    mu = (polarity[:, None] * k1[0]).contiguous()
    k2, finite2, same2 = written_twice(lambda: ED.direct_energy_force_pot(sites, mu, consts),
                                       [(n, 3), (n,), (n,)] + scratch_shapes(n, 5))
    for name, kern, fin, rep in (('fixed_field_and_scf_factors', k1, finite, same),
                                 ('direct_energy_force_pot', k2, finite2, same2)):
        h = digest(kern)
        print(f'  {name:28s} outputs sha256 {h}; every entry written (finite after NaN '
              f'fill): {fin}; two calls equal: {rep}', flush=True)
        out[name] = dict(sha256=h, finite=fin, repeat=rep)
        failures += [f'{tag}.{name}.{what}' for what, ok in (('finite', fin), ('repeat', rep))
                     if not ok]
    print(f'  s3, s5 exactly symmetric with a zero diagonal: {sym}; {n_in} in-cutoff ordered '
          f'pairs ({n_in // 2} unordered) of {n * (n - 1)}', flush=True)
    out['symmetric'] = sym
    out['n_in_cutoff_ordered'] = n_in
    if not sym:
        failures.append(f'{tag}.symmetric')

    t1 = ED.fixed_field_and_scf_factors_tri_plain(sites, consts)
    t1_64 = ED.fixed_field_and_scf_factors_tri_plain(sites.double(), consts)
    t2 = ED.direct_energy_force_pot_tri_plain(sites, mu, consts)
    torch.cuda.synchronize()
    for name, rows, kern, twin in (
            ('fixed_field_and_scf_factors', check.k1_rows(sites, polarity, k1, t1, t1_64), k1, t1),
            ('direct_energy_force_pot', check.k2_rows(k2, t2), k2, t2)):
        err = max(float((k - t).abs().max()) for k, t in zip(kern, twin))
        bad = [str(r) for r in rows if not r.ok]
        print(f'  {name:28s} vs the triangular twins: max |kernel - twin| {err:.3e}; '
              f'{len(rows) - len(bad)}/{len(rows)} rows pass', flush=True)
        for r in rows:
            print(f'    {r}')
        failures += [f'{tag}.{name}.{r}' for r in bad]
        out[name]['max_abs_err'] = err
    del t1, t1_64, t2

    bounds = dense_bounds(n, n_in // 2, rate)
    calls = {'fixed_field_and_scf_factors': lambda: ED.fixed_field_and_scf_factors(sites, consts),
             'direct_energy_force_pot': lambda: ED.direct_energy_force_pot(sites, mu, consts)}
    for name, call in calls.items():
        dev = kernel_device_ms(call, KERNEL_NAMES[name], args.reps, (HELPER,))
        loop = loop_ms(call, args.reps)
        bound_ms, by = bounds[name]
        below = dev.ms is None or dev.ms < bound_ms
        print(f'  {name:28s} device {dev.ms} ms per launch (kernel {dev.kernel_ms} + {HELPER} '
              f'{dev.helper_ms}; {dev.launches} launches traced of {args.reps} calls; every '
              f'kernel in the trace: ' + ', '.join(f'{k} {v:.4f}' for k, v in dev.each.items())
              + f'); back to back {loop:.4f} ms per call; bound {bound_ms:.4f} ms ({by})'
              + (' BELOW THE BOUND OR NOT TRACED: a miscount' if below else '')
              + f' ({card})', flush=True)
        out[name].update(ms=dev.ms, kernel_ms=dev.kernel_ms, helper_ms=dev.helper_ms,
                         launches=dev.launches, each_ms=dev.each, loop_ms=loop,
                         bound_ms=bound_ms, bound_by=by)
        if below:
            failures.append(f'{tag}.{name}.device_time')
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--waters', type=int, nargs='+', choices=sorted(REPS), default=sorted(REPS))
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('dense_probe needs a CUDA card')
    import mbpol_openmm_plugin_tpu_torch  # noqa: F401  (precision switches)
    from mbpol_openmm_plugin_tpu_torch.ops import _build

    card = card_line()
    _build.build()
    for line in resource_lines(_build.build_log()):
        print('  ' + line)
    result, failures = dict(card=card, sizes={}), []
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    floor = kernel_device_ms(lambda: lib.mbpol_empty_launch(stream), 'empty_kernel',
                             args.reps).ms
    print(f'  empty kernel launch: {floor} ms device time (the floor per launch; {card})',
          flush=True)
    result['empty_launch_ms'] = floor
    rate = transcendental_rate()
    for waters in args.waters:
        result['sizes'][f'water{waters}'] = probe_size(waters, args, card, rate, failures)
        torch.cuda.empty_cache()
    result['failures'] = failures
    print(card)
    print(json.dumps(result))
    return 1 if failures else 0


if __name__ == '__main__':
    sys.exit(main())
