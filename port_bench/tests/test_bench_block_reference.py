"""The port in the water4096 cell's modes against the plain reference
(port_bench/reference) on the CPU in float64, on upstream's water256 box
replicated and jiggled by a seeded generator (MB-pol's parameters are
published constants, so the seed goes into the positions).

MBPol is built as the cell builds it (configs/water4096_bulk.json:
block-sparse PME direct space, water-pair dispersion, tune_capacities, the
triplet slots per centre left open). Each term agrees within the reference
tests' tolerances (1e-6 kJ/mol, electrostatics 1e-3: the two SOR loops stop
at slightly different dipoles), the forces within 1e-6 of the largest force
(both loops converge to 1e-9; the gap reads ~2.5e-12 of the largest force
at water256). Here the box replicated (2, 1, 1), so that the serpentine
sort and the tile-pair list span two copies: ~80 s on one CPU thread, too
long for the repository's tier-1 tests, which hold (1, 1, 1) with the
same helpers (tests/test_torch_block_reference.py).
"""
import json
import os

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.system import (System, compute_virtual_sites,
                                                  make_molecules_whole, replicate)
from port_bench.harness import spec, sut
from port_bench.reference import mbpol as R

SEED = 2 ** 31 + 4099


def water4096():
    with open(os.path.join(spec.BENCH_DIR, 'configs', 'water4096_bulk.json')) as f:
        return json.load(f)


def cell_potential(config, replicas):
    """(MBPol in the cell's modes on the CPU, float64 positions [4n, 3]
    jiggled from the seed, the box)."""
    names, resnames, positions = sut.load_positions(config)
    system = System.from_atom_names(names, resnames, box=[config['box_nm']] * 3)
    pos = compute_virtual_sites(system, make_molecules_whole(
        system, torch.as_tensor(positions, dtype=torch.float64)))
    if tuple(replicas) != (1, 1, 1):
        system, pos = replicate(system, pos, tuple(replicas))
    gen = torch.Generator().manual_seed(SEED + sum(replicas))
    pos = compute_virtual_sites(system, pos + 0.002 * torch.randn(pos.shape, generator=gen,
                                                                   dtype=torch.float64))
    cfg = MBPolConfig.for_dynamics(
        cutoff=config['cutoff'], cutoff_2b=config['cutoff_2b'], cutoff_3b=config['cutoff_3b'],
        ewald_error_tolerance=config['ewald_error_tolerance'],
        dispersion_switch_width=config['dispersion_switch_width'],
        nlist_skin=config['nlist_skin'], electrostatics_mode=config['electrostatics_mode'],
        dispersion_mode=config['dispersion_mode'], scf_method='sor', target_epsilon=1e-9)
    pot = MBPol(system, cfg, device='cpu')
    assert config['tune_capacities']
    pot.tune_capacities(pos)
    pot.nlist_kt = config['nlist_kt']
    return pot, pos, [float(b) for b in system.box]


def check_against_reference(replicas):
    config = water4096()
    pot, pos, box = cell_potential(config, replicas)
    assert pot.elec_mode == 'block' and pot.disp_mode == 'pairs' and pot.nlist_kt is None
    e, f, parts, diag = pot.energy_forces(pos)
    assert not bool(diag['elec_tile_overflow']) and not bool(diag['elec_line_overflow'])
    r = R.evaluate(pos.numpy(), box, config, scf_epsilon=1e-9)
    for term in ('one_body', 'two_body', 'three_body', 'dispersion'):
        assert abs(r['terms'][term] - float(parts[term])) < 1e-6, term
    assert abs(r['terms']['electrostatics'] - float(parts['electrostatics'])) < 1e-3
    ref_f = r['forces'].numpy()
    assert np.max(np.abs(f.numpy() - ref_f)) < 1e-6 * np.max(np.abs(ref_f))
    return pot, diag


def test_block_cell_matches_the_reference_two_copies():
    pot, diag = check_against_reference((2, 1, 1))
    # the sort interleaves the copies' waters; the box is 1.94 nm wide, so
    # each of its 8 row tiles comes within the cutoff of every other
    perm = pot._block_info['site_perm']
    assert not np.array_equal(perm, np.arange(len(perm)))
    assert int(diag['elec_tile_pairs']) == 64
