"""The three block-sparse electrostatics kernels of csrc/elec_direct_bs.cu
alone, on one CUDA card, at water4096 (the water256 fixture repeated
2 x 2 x 4, 16,384 sites, sorted and listed as tune_capacities does):
a short build-check-time run (chip_smoke.py phase 6 holds them too).

    python -m mbpol_openmm_plugin_tpu_torch.tools.block_probe [--reps 20]

Builds the kernels and prints the compiler's resource lines of the three
block kernels. Then, on the sites as tune_capacities sorts them and on the
same sites shifted by one box vector along each axis (unwrapped
coordinates), runs K1-bs, K3-bs and K2-bs, checks each against its plain
twin on the entry sets of ops/elec_direct_check.py, checks that two calls
give the same bits and that the shifted sites give the unshifted outputs'
checks, and prints a SHA-256 of each kernel's outputs: K1-bs's field and
its s3/s5 spread into the [256 x 256] blocks of the valid list entries
(zeros outside its lines, the bytes a kernel that writes whole blocks
gives), K3-bs's field on those s3/s5, K2-bs's outputs. The same inputs give
the same hash on every tree whose kernels keep their summation order,
whatever the s3/s5 layout. Prints the line capacity, the live lines per
slab and the s3/s5 bytes allocated, and times each kernel per launch
(torch.profiler device time, and back to back between CUDA events). Exits
non-zero when a check fails. Prints the card's name and power limit and
one JSON object as the last line.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch.tools.timing import card_line, kernel_device_ms, loop_ms

BOX = 19.3996888399961804 / 10.0
REPS = (2, 2, 4)
KERNEL_NAMES = {'fixed_field_and_scf_lines': 'fixed_field_bs_kernel',
                'scf_dipole_field_bs': 'scf_field_bs_kernel',
                'direct_energy_force_pot_bs': 'direct_efp_bs_kernel'}
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), 'tests', 'fixtures', 'water256_integration_test.npz')


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def water4096_block():
    """(sorted padded sites, polarity in that order, tile list, n, consts,
    box, s3/s5 line capacity) at water4096 on the card, as tune_capacities
    and the block branch of models/pme build them."""
    from mbpol_openmm_plugin_tpu_torch.models import electrostatics as elec
    from mbpol_openmm_plugin_tpu_torch.models import pme
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
    from mbpol_openmm_plugin_tpu_torch.system import (System, compute_virtual_sites,
                                                      make_molecules_whole, replicate)
    with np.load(FIXTURE) as z:
        system = System.from_atom_names(z['names'], z['resnames'], box=[BOX] * 3)
        pos = torch.as_tensor(np.array(z['positions']), dtype=torch.float32, device='cuda')
    pos = compute_virtual_sites(system, make_molecules_whole(system, pos))
    big, pos = replicate(system, pos, REPS)
    pos = compute_virtual_sites(big, pos)
    pot = MBPol(big, MBPolConfig.for_dynamics()).tune_capacities(pos)
    params, block = pot.elec_params, pot._block_info
    charges, _ = elec.assemble_charges(params, pos)
    sites, (tiles,) = pme.block_sites(params, pot.pme, pos, charges, block)
    polarity = torch.as_tensor(params.polarity[block['site_perm']], dtype=torch.float32,
                               device='cuda')
    consts = ED.DirectConsts.from_setup(pot.pme, params.thole)
    return (sites, polarity, tiles, pos.shape[0], consts, np.asarray(big.box, np.float64),
            block['line_capacity'])


def resource_lines(build_log):
    lines, keep = [], False
    for line in build_log.splitlines():
        if 'Compiling entry function' in line:
            keep = any(k in line for k in KERNEL_NAMES.values())
        if keep and any(w in line for w in ('Compiling', 'registers', 'spill')):
            lines.append(line.strip())
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('block_probe needs a CUDA card')
    import mbpol_openmm_plugin_tpu_torch  # noqa: F401  (precision switches)
    from mbpol_openmm_plugin_tpu_torch.ops import _build
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as BS
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_check as check

    card = card_line()
    _build.build()
    for line in resource_lines(_build.build_log()):
        print('  ' + line)
    sites, polarity, tiles, n, consts, box, line_capacity = water4096_block()
    np_ = sites.shape[0]
    live = BS.live_lines(sites[:, :3], n, tiles, box, consts.cutoff)
    n_all = int(((tiles.meta & BS.VALID) > 0).sum()) * live.shape[1] * live.shape[2]
    print(f'water4096: sites {tuple(sites.shape)}, n_act {int(tiles.n_act)} of capacity '
          f'{tiles.capacity}; live (water, cluster) lines {int(live.sum())} of {n_all} '
          f'({int(live.sum()) / n_all:.4f})', flush=True)
    failures, out = [], dict(card=card, kernels={})

    n_lines = line_capacity
    field, lines = BS.fixed_field_and_scf_lines(sites, n, tiles, consts, n_lines)
    mu = (polarity[:, None] * field).contiguous()
    mu_pad = BS.pad_rows(mu, np_)
    torch.cuda.synchronize()
    print(f'  s3/s5 lines: capacity {n_lines} (the column tiles: {np_ // BS.TILE}); live lines '
          f'per slab max {int(lines.count.max())}, mean {float(lines.count.float().mean()):.2f}, '
          f'all {int(lines.count.sum())}; allocated {lines.nbytes()} bytes', flush=True)
    out.update(line_capacity=n_lines, s3_s5_bytes=lines.nbytes())
    valid = (tiles.meta & BS.VALID) > 0

    def k1_outputs(k1):
        """The field, the valid entries' blocks (the hashed form) and the
        stored lines with their counts and entries (the compared form)."""
        f, ln = k1
        stored = torch.arange(ln.capacity, device=ln.count.device) < ln.count[..., None]
        b3, b5 = BS.lines_to_blocks(ln, tiles)
        return ((f, b3[valid], b5[valid]),
                (f, ln.count, ln.entry[stored], ln.s3[stored], ln.s5[stored]))

    calls = {
        'fixed_field_and_scf_lines': lambda s: BS.fixed_field_and_scf_lines(s, n, tiles, consts,
                                                                            n_lines),
        'scf_dipole_field_bs': lambda s: (BS.scf_dipole_field_bs(s, lines, mu_pad, tiles, n,
                                                                 consts),),
        'direct_energy_force_pot_bs': lambda s: BS.direct_energy_force_pot_bs(s, mu, n, tiles,
                                                                              consts)}
    for name, call in calls.items():
        a, b = call(sites), call(sites)
        torch.cuda.synchronize()
        if name == 'fixed_field_and_scf_lines':
            (a, a_cmp), (_, b_cmp) = k1_outputs(a), k1_outputs(b)
        else:
            a_cmp, b_cmp = a, b
        same = all(torch.equal(x, y) for x, y in zip(a_cmp, b_cmp))
        h = digest(a)
        print(f'  {name:28s} outputs sha256 {h}; two calls equal: {same}', flush=True)
        if not same:
            failures.append(f'{name}.repeat')
        out['kernels'][name] = dict(sha256=h)
        del a, b, a_cmp, b_cmp

    shift = torch.as_tensor(box, dtype=sites.dtype, device=sites.device)
    for label, s in (('sorted', sites),
                     ('shifted by +box', torch.cat([sites[:, :3] + shift, sites[:, 3:]], 1)),
                     ('shifted by -2 box', torch.cat([sites[:, :3] - 2 * shift, sites[:, 3:]],
                                                     1))):
        rows = check.block_kernel_rows(s.contiguous(), polarity, tiles, n, consts, n_lines)
        torch.cuda.synchronize()
        for name, (rs, err) in rows.items():
            bad = [str(r) for r in rs if not r.ok]
            print(f'  {label:18s} {name:28s} max |kernel - twin| {err:.3e}; '
                  f'{len(rs) - len(bad)}/{len(rs)} rows pass', flush=True)
            for r in bad:
                print('    FAIL ' + r)
            failures += [f'{label}.{name}.{r}' for r in bad]

    for name, call in calls.items():
        dev = kernel_device_ms(lambda: call(sites), KERNEL_NAMES[name], args.reps,
                               ('cluster_boxes_kernel',))
        ms, boxes_ms = dev.kernel_ms, dev.helper_ms
        loop = loop_ms(lambda: call(sites), args.reps)
        print(f'  {name:28s} device {ms} ms per launch, cluster boxes {boxes_ms} ms; back to '
              f'back {loop:.4f} ms per call ({card})', flush=True)
        out['kernels'][name].update(ms=ms, boxes_ms=boxes_ms, loop_ms=loop)
    out['failures'] = failures
    print(card)
    print(json.dumps(out))
    return 1 if failures else 0


if __name__ == '__main__':
    sys.exit(main())
