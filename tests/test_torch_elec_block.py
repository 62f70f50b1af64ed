"""The block-sparse direct-space path of the port (ops/elec_direct_bs and
the block branch of models/pme) against the JAX package, CPU float64.

(a) Tile machinery equals the JAX functions exactly (sort permutation,
    capacity, the full-list count tune_capacities takes against JAX's host
    count, ti/tj/meta/n_act) on the water256 fixture at
    cutoff 0.45 (4 row tiles, every tile pair active) and on water1024 (the
    fixture repeated 4 x 1 x 1, 16 row tiles) at cutoff 0.45, where 32 of
    256 tile pairs are inactive, each also with a capacity below the active
    count.
(b) Each block twin against the JAX block kernel in interpret mode at
    water50 (one row tile; a capacity of 4 adds three padded entries),
    atol 2e-3 (the bound of test_torch_elec_direct.py for the kernels'
    erfc/H2 fits), the port's s3/s5 lines spread into the JAX blocks'
    layout (lines_to_blocks) or the JAX blocks cut into lines
    (blocks_to_lines); and pme_electrostatics in block mode against JAX's
    with MBPOL_ELEC_PALLAS=interpret, atol 2e-3 and equal SCF iterations.
(c) The port's block-mode pme_electrostatics against the JAX XLA dense
    path at water256, cutoff 0.45: |dE| <= 1e-6 kJ/mol, max |dF| <= 1e-6
    kJ/mol/nm, equal SCF iterations.
(d) Replication identity of the port in block mode: water50 repeated
    2 x 1 x 1 with the PME grid doubled along x gives the same energy per
    water to 1e-9 relative and the same forces on every copy to 1e-9 of
    max |F| (every cutoff is below half the water50 box).
(e) A line capacity below the live lines of a slab sets
    elec_line_overflow, and Simulation stops on it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu.models import electrostatics as jelec
from mbpol_openmm_plugin_tpu.models import pme as jpme
from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
from mbpol_openmm_plugin_tpu.ops import elec_pallas as EP
from mbpol_openmm_plugin_tpu.ops import elec_pallas_bs as JBS
from mbpol_openmm_plugin_tpu.system import compute_virtual_sites, make_molecules_whole
from mbpol_openmm_plugin_tpu_torch.models import pme as tpme
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as BS
from mbpol_openmm_plugin_tpu_torch.system import System, replicate

torch.set_num_threads(1)

BOX256 = 19.3996888399961804 / 10.0
PALLAS_TOL = dict(rtol=0, atol=2e-3)
ATOL_CONTEXT = 1e-6
REPLICA_REL = 1e-9


def _water256(reps=(1, 1, 1)):
    """(JAX-side positions with M sites [n, 3] numpy, box) of the water256
    fixture repeated reps times."""
    jsys, pos = fixtures.load_system('water256_integration_test', box=[BOX256] * 3)
    pos = np.asarray(compute_virtual_sites(jsys, make_molecules_whole(jsys, pos)))
    d = fixtures.load('water256_integration_test')
    tsys = System.from_atom_names(d['names'], d['resnames'], box=[BOX256] * 3)
    big, tpos = replicate(tsys, torch.as_tensor(pos), reps)
    return tpos.numpy(), np.asarray(big.box)


def _sorted(pos, box):
    """The tune_capacities site sort of both packages, checked equal."""
    o = pos[0::4]
    perm_j = np.asarray(JBS.molecule_sort_permutation(o, box))
    perm_t = BS.molecule_sort_permutation(o, box)
    np.testing.assert_array_equal(perm_t, perm_j)
    site_perm = (4 * perm_t[:, None] + np.arange(4)[None, :]).reshape(-1)
    return pos[site_perm], site_perm


@pytest.mark.parametrize('case', ['water256', 'water256_overflow',
                                  'water1024', 'water1024_overflow'])
def test_tile_machinery_matches_jax(case):
    reps, cutoff = ((1, 1, 1) if case.startswith('water256') else (4, 1, 1)), 0.45
    pos, box = _water256(reps)
    n = pos.shape[0]
    pos_s, _ = _sorted(pos, box)
    npad = BS.padded(n)
    assert npad == EP._padded(n)
    assert BS.tile_pair_capacity(n, box, cutoff) == JBS.tile_pair_capacity(n, box, cutoff)

    p_pad = np.zeros((npad, 3))
    p_pad[:n] = pos_s
    n_tiles = npad // BS.TILE
    # the count tune_capacities takes (a list holding every tile pair)
    # against the JAX host count and activity matrix
    n_act_j, _, act_j = JBS.active_tile_pairs_host(pos_s, n, box, cutoff, npad)
    full = BS.active_tile_pairs(torch.as_tensor(p_pad), n, box, cutoff, n_tiles * n_tiles)
    n_act_t = int(full.n_act)
    assert n_act_t == n_act_j
    listed = (full.meta.numpy() & BS.VALID) > 0
    np.testing.assert_array_equal(full.ti.numpy()[listed] * n_tiles + full.tj.numpy()[listed],
                                  np.flatnonzero(act_j))
    if case.startswith('water1024'):
        assert 0 < n_act_t < n_tiles * n_tiles      # some tile pairs inactive
    cap = n_act_t - 3 if case.endswith('overflow') else n_act_t + 5

    ti_j, tj_j, meta_j, nact_j = JBS.active_tile_pairs(jnp.asarray(p_pad), n, box, cutoff, cap)
    tiles = BS.active_tile_pairs(torch.as_tensor(p_pad), n, box, cutoff, cap)
    assert int(tiles.n_act) == int(nact_j) == n_act_t
    np.testing.assert_array_equal(tiles.ti.numpy(), np.asarray(ti_j))
    np.testing.assert_array_equal(tiles.tj.numpy(), np.asarray(tj_j))
    np.testing.assert_array_equal(tiles.meta.numpy(), np.asarray(meta_j))
    # each row tile's run of the list starts at row_start
    ti = tiles.ti.numpy()
    rs = tiles.row_start.numpy()
    assert rs[0] == 0 and rs[-1] == cap
    for t in range(n_tiles):
        assert np.all(ti[rs[t]:rs[t + 1]] == t)


@pytest.fixture(scope='module')
def water50():
    box = [1.8] * 3
    jsys, pos = fixtures.load_system('water50', box=box)
    pos_v = np.asarray(compute_virtual_sites(jsys, make_molecules_whole(jsys, pos)))
    jpot = JMBPol(jsys, JConfig(nonbonded_method='PME', cutoff=0.85, target_epsilon=1e-7))
    params = jpot.elec_params
    n = pos_v.shape[0]
    pos_s, site_perm = _sorted(pos_v, np.asarray(box))
    charges = np.asarray(jelec.assemble_charges(params, jnp.asarray(pos_v))[0])[site_perm]
    d16 = (np.asarray(params.damping) ** (-1.0 / 6.0))[site_perm]
    mol, is_o = np.asarray(params.mol_index)[site_perm], (params.atom_type == 0)[site_perm]
    srow = EP.pack_sites(jnp.asarray(pos_s), jnp.asarray(charges), jnp.asarray(d16),
                         jnp.asarray(mol), jnp.asarray(is_o))
    sites = BS.pack_sites(torch.as_tensor(pos_s), torch.as_tensor(charges),
                          torch.as_tensor(d16), torch.as_tensor(mol), torch.as_tensor(is_o))
    cap = 4
    ti, tj, meta, _ = JBS.active_tile_pairs(srow[:, :3], n, box, jpot.pme.cutoff, cap)
    tiles = BS.active_tile_pairs(sites[:, :3], n, box, jpot.pme.cutoff, cap)
    assert int(tiles.n_act) == 1 and tiles.capacity == cap
    np.testing.assert_array_equal(tiles.meta.numpy(), np.asarray(meta))
    consts = ED.DirectConsts.from_setup(jpot.pme, params.thole)
    mu = 0.01 * np.sin(np.arange(3 * n, dtype=np.float64)).reshape(-1, 3)
    return dict(jpot=jpot, pos_v=pos_v, site_perm=site_perm, srow=srow, sites=sites,
                jtiles=(ti, tj, meta), tiles=tiles, consts=consts, n=n, mu=mu)


def test_k1_bs_twin_vs_pallas_interpret(water50):
    w = water50
    jp, n = w['jpot'], w['n']
    ef_j, s3_j, s5_j = JBS.fixed_field_and_scf_blocks(jp.pme, jp.elec_params.thole, w['srow'],
                                                      n, *w['jtiles'], interpret=True)
    ef_t, lines = BS.fixed_field_and_scf_lines(w['sites'], n, w['tiles'], w['consts'])
    assert lines.capacity == 1 and not bool(lines.overflow())
    s3_t, s5_t = BS.lines_to_blocks(lines, w['tiles'])
    assert s3_t.shape == (4, BS.TILE, BS.TILE)
    np.testing.assert_allclose(ef_t.numpy(), np.asarray(ef_j), **PALLAS_TOL)
    np.testing.assert_allclose(s3_t.numpy(), np.asarray(s3_j), **PALLAS_TOL)
    np.testing.assert_allclose(s5_t.numpy(), np.asarray(s5_j), **PALLAS_TOL)
    assert not s3_t[1:].any() and not s5_t[1:].any()      # the twin zeroes padded entries


def test_k3_bs_twin_vs_pallas_interpret(water50):
    """The same s3/s5 (the JAX kernel's blocks) into both, cut into lines on
    the port's side; there the blocks of the padded entries hold NaN, and
    so do the slots past each slab's lines, as K1-bs leaves them
    unwritten: neither must reach the field."""
    w = water50
    jp, n = w['jpot'], w['n']
    _, s3_j, s5_j = JBS.fixed_field_and_scf_blocks(jp.pme, jp.elec_params.thole, w['srow'], n,
                                                   *w['jtiles'], interpret=True)
    mu_s = w['mu'][w['site_perm']]
    npad = w['srow'].shape[0]
    mp = jnp.zeros((npad, EP._NS)).at[:n, :3].set(jnp.asarray(mu_s))
    f_j = JBS.scf_dipole_field_bs(jp.pme, jp.elec_params.thole, w['srow'], s3_j, s5_j, mp,
                                  *w['jtiles'], n, interpret=True)
    s3_t, s5_t = (torch.as_tensor(np.array(s)) for s in (s3_j, s5_j))
    padded_entries = (w['tiles'].meta & BS.VALID) == 0
    assert int(padded_entries.sum()) == 3
    s3_t[padded_entries] = float('nan')
    s5_t[padded_entries] = float('nan')
    sites, tiles = w['sites'], w['tiles']
    live = BS.live_lines(sites[:, :3], n, tiles, w['consts'].box, w['consts'].cutoff)
    lines = BS.blocks_to_lines(s3_t, s5_t, tiles, live, 1)
    unused = torch.arange(lines.capacity) >= lines.count[..., None]
    assert bool(unused.any())                      # the padded waters' slabs
    lines.s3[unused] = float('nan')
    lines.s5[unused] = float('nan')
    f_t = BS.scf_dipole_field_bs(sites, lines, BS.pad_rows(torch.as_tensor(mu_s), npad), tiles,
                                 n, w['consts'])
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), **PALLAS_TOL)


def test_k2_bs_twin_vs_pallas_interpret(water50):
    w = water50
    jp, n = w['jpot'], w['n']
    mu_s = w['mu'][w['site_perm']]
    e_j, f_j, p_j = JBS.direct_energy_force_pot_bs(jp.pme, jp.elec_params.thole, w['srow'],
                                                   jnp.asarray(mu_s), n, *w['jtiles'],
                                                   interpret=True)
    e_t, f_t, p_t = BS.direct_energy_force_pot_bs(w['sites'], torch.as_tensor(mu_s), n,
                                                  w['tiles'], w['consts'])
    np.testing.assert_allclose(float(e_t), float(e_j), **PALLAS_TOL)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), **PALLAS_TOL)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), **PALLAS_TOL)


def test_block_pme_vs_jax_block_interpret(water50, monkeypatch):
    """In context: the port's block branch (twins on the CPU) against the
    JAX block branch running the Pallas kernels in interpret mode."""
    w = water50
    jp = w['jpot']
    perm = w['site_perm']
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    monkeypatch.setenv('MBPOL_ELEC_PALLAS', 'interpret')
    e_j, f_j, d_j = jpme.pme_electrostatics(
        jp.elec_params, jp.pme, jnp.asarray(w['pos_v']),
        block=dict(site_perm=perm, site_perm_inv=inv, tile_pair_capacity=4))
    tpot = MBPol(_tsys('water50', [1.8] * 3),
                 MBPolConfig(nonbonded_method='PME', cutoff=0.85, target_epsilon=1e-7),
                 device='cpu')
    e_t, f_t, d_t = tpme.pme_electrostatics(tpot.elec_params, tpot.pme,
                                            torch.as_tensor(w['pos_v']),
                                            block=tpme.block_info(perm, 4, 'cpu'))
    np.testing.assert_allclose(float(e_t), float(e_j), **PALLAS_TOL)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), **PALLAS_TOL)
    assert int(d_t['iterations']) == int(d_j['iterations'])
    assert int(d_t['elec_tile_pairs']) == int(d_j['elec_tile_pairs']) == 1
    assert not bool(d_t['elec_tile_overflow'])


def _tsys(name, box):
    d = fixtures.load(name)
    return System.from_atom_names(d['names'], d['resnames'], box=box)


def test_block_pme_vs_jax_dense_water256():
    """(c): block mode (sorted, 4 row tiles, padded list) against the JAX
    XLA dense path, the same function."""
    box = [BOX256] * 3
    cfg = dict(nonbonded_method='PME', cutoff=0.45, target_epsilon=1e-7)
    jsys, pos = fixtures.load_system('water256_integration_test', box=box)
    pos_v = np.asarray(compute_virtual_sites(jsys, make_molecules_whole(jsys, pos)))
    jpot = JMBPol(jsys, JConfig(**cfg))
    e_j, f_j, d_j = jpme.pme_electrostatics(jpot.elec_params, jpot.pme, jnp.asarray(pos_v))

    tpot = MBPol(_tsys('water256_integration_test', box), MBPolConfig(**cfg), device='cpu')
    _, site_perm = _sorted(pos_v, np.asarray(box))
    cap = BS.tile_pair_capacity(pos_v.shape[0], box, 0.45)
    e_t, f_t, d_t = tpme.pme_electrostatics(tpot.elec_params, tpot.pme, torch.as_tensor(pos_v),
                                            block=tpme.block_info(site_perm, cap, 'cpu'))
    assert int(d_t['elec_tile_pairs']) <= cap and not bool(d_t['elec_tile_overflow'])
    assert abs(float(e_t) - float(e_j)) <= ATOL_CONTEXT
    assert np.max(np.abs(f_t.numpy() - np.asarray(f_j))) <= ATOL_CONTEXT
    assert int(d_t['iterations']) == int(d_j['iterations'])
    assert bool(d_t['converged'])


def test_block_mode_replication_identity():
    """(d): water50 and water50 x (2, 1, 1), block + pairs modes, float64."""
    box = [1.8] * 3
    cfg = dict(nonbonded_method='PME', cutoff=0.85, electrostatics_mode='block',
               dispersion_mode='pairs')
    sys1 = _tsys('water50', box)
    d = fixtures.load('water50')
    from mbpol_openmm_plugin_tpu_torch.system import make_molecules_whole as whole
    pos1 = whole(sys1, torch.as_tensor(np.array(d['positions'])))
    pot1 = MBPol(sys1, MBPolConfig(**cfg), device='cpu')
    grid = pot1.pme.grid
    sys2, pos2 = replicate(sys1, pos1, (2, 1, 1))
    pot2 = MBPol(sys2, MBPolConfig(pme_grid=(2 * grid[0], grid[1], grid[2]), **cfg),
                 device='cpu')
    assert pot2.elec_mode == 'block' and pot2.pme.alpha == pot1.pme.alpha
    e1, f1, _, d1 = pot1.energy_forces(pos1)
    e2, f2, _, d2 = pot2.energy_forces(pos2)
    assert int(d2['elec_tile_pairs']) == 4           # 400 sites: two row tiles
    assert int(d1['iterations']) == int(d2['iterations'])
    assert abs(float(e2) / 2.0 - float(e1)) <= REPLICA_REL * abs(float(e1))
    fmax = float(f1.abs().max())
    n_atoms = pos1.shape[0]
    for copy in range(2):
        df = (f2[copy * n_atoms:(copy + 1) * n_atoms] - f1).abs().max()
        assert float(df) <= REPLICA_REL * fmax


def test_line_overflow_stops_the_simulation():
    """(e): water50 x (2, 1, 1), block + pairs modes under for_dynamics:
    two row tiles, so a water near the tiles' boundary holds live lines of
    both column tiles; a capacity of one line sets elec_line_overflow and
    Simulation raises at the end of the chunk."""
    box = [1.8] * 3
    cfg = MBPolConfig.for_dynamics(cutoff=0.85, electrostatics_mode='block',
                                   dispersion_mode='pairs')
    sys1 = _tsys('water50', box)
    d = fixtures.load('water50')
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
    from mbpol_openmm_plugin_tpu_torch.system import make_molecules_whole as whole
    sys2, pos2 = replicate(sys1, whole(sys1, torch.as_tensor(np.array(d['positions']))),
                           (2, 1, 1))
    pot = MBPol(sys2, cfg, device='cpu')
    info = pot._block_info
    assert info['line_capacity'] == 2                  # the column tiles: no overflow
    assert not bool(pot.energy_forces(pos2)[3]['elec_line_overflow'])
    pot._set_block_perm(info['site_perm'], info['tile_pair_capacity'], 1)
    assert bool(pot.energy_forces(pos2)[3]['elec_line_overflow'])
    sim = Simulation(pot, SimulationConfig(dt=0.0002, nlist_rebuild_interval='auto'))
    sim.set_positions(pos2)
    with pytest.raises(RuntimeError, match='overflow'):
        sim.step(1)
