"""The port's MBPol.energy_forces against the JAX MBPol, CPU float64, on
water14 and water50 PME (cutoff 0.9 nm, box 1.8 nm), in the dense modes
and (water50) in the block electrostatics + pair dispersion modes, with the
JAX potential's parameters, PME setup, list capacities and block layout
carried across by convert.from_jax_arrays. Bounds: |dE| <= 1e-6 kJ/mol per
term, max |dF| <= 1e-6 kJ/mol/nm, equal SCF iteration counts; plus the
reference golden totals of test_potential_pme.py. Also: tune_capacities
gives the JAX tuned fields on water256, 'auto' resolves the modes as JAX
does on both sides of 512 and 2560 waters, and 'sparse' (the option
outside the port) raises.
"""

import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
from mbpol_openmm_plugin_tpu_torch import convert
from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.system import System

torch.set_num_threads(1)

GOLDEN_KCAL = {'water14': (-60.0, 1.0), 'water50': (-244.37507, 1.0),
               'water50_block': (-244.37507, 1.0)}
BLOCK = dict(electrostatics_mode='block', dispersion_mode='pairs')
TERMS = ('one_body', 'two_body', 'three_body', 'dispersion', 'electrostatics')


def jax_arrays(jpot):
    """The JAX potential's state as numpy arrays and scalars."""
    ep, pme = jpot.elec_params, jpot.pme
    out = dict(thole=np.asarray(ep.thole), polarity=np.asarray(ep.polarity),
               damping=np.asarray(ep.damping), mol_index=np.asarray(ep.mol_index),
               atom_type=np.asarray(ep.atom_type), charges=np.asarray(ep.charges),
               pme_alpha=pme.alpha, pme_grid=pme.grid, pme_cutoff=pme.cutoff,
               pme_box=pme.box)
    if jpot.use_neighbor_lists:
        out.update(pair_cap=jpot.pair_cap, trip_cap=jpot.trip_cap,
                   nlist_k_max=jpot.nlist_k_max, nlist_kt=jpot.nlist_kt)
    if jpot.disp_mode == 'pairs':
        out.update(disp_pair_cap=jpot.disp_pair_cap)
    if jpot.elec_mode == 'block':
        out.update(site_perm=jpot._block_info['site_perm'],
                   tile_pair_capacity=jpot._block_info['tile_pair_capacity'])
    return out


@pytest.fixture(scope='module', params=['water14', 'water50', 'water50_block'])
def evaluated(request):
    name = request.param
    modes = BLOCK if name.endswith('_block') else {}
    fixture = name.replace('_block', '')
    box = [1.8] * 3
    jsys, pos = fixtures.load_system(fixture, box=box)
    jpot = JMBPol(jsys, JConfig(nonbonded_method='PME', cutoff=0.9, **modes))
    if modes:
        # the JAX package's tuned capacities and serpentine site sort
        jpot.tune_capacities(pos)
    ej, fj, pj, dj = jpot.energy_forces(pos)
    d = fixtures.load(fixture)
    tsys = System.from_atom_names(d['names'], d['resnames'], box=box)
    tpot = convert.from_jax_arrays(tsys, MBPolConfig(nonbonded_method='PME', cutoff=0.9,
                                                     **modes),
                                   device='cpu', **jax_arrays(jpot))
    assert (tpot.elec_mode, tpot.disp_mode) == (jpot.elec_mode, jpot.disp_mode)
    if modes:
        np.testing.assert_array_equal(tpot._block_info['site_perm'],
                                      jpot._block_info['site_perm'])
    assert tpot.use_neighbor_lists == jpot.use_neighbor_lists
    et, ft, pt, dt = tpot.energy_forces(torch.as_tensor(np.array(pos)))
    return name, (float(ej), np.asarray(fj), {k: float(v) for k, v in pj.items()}, dj), \
        (float(et), ft.numpy(), {k: float(v) for k, v in pt.items()}, dt)


def test_energy_terms_match_jax(evaluated):
    _, (ej, _, pj, _), (et, _, pt, _) = evaluated
    assert set(pt) == set(TERMS) == set(pj)
    for k in TERMS:
        assert abs(pt[k] - pj[k]) <= 1e-6, (k, pt[k], pj[k])
    assert abs(et - ej) <= 1e-6


def test_forces_match_jax(evaluated):
    _, (_, fj, _, _), (_, ft, _, _) = evaluated
    assert np.all(np.isfinite(ft))
    assert np.max(np.abs(ft - fj)) <= 1e-6
    # M-site rows are zero after redistribution to the parents
    np.testing.assert_array_equal(ft[3::4], 0.0)


def test_scf_and_lists_match_jax(evaluated):
    _, (_, _, _, dj), (_, _, _, dt) = evaluated
    assert int(dt['iterations']) == int(dj['iterations'])
    assert bool(dt['converged']) and bool(dj['converged'])
    for k in ('n_pairs', 'n_triplets', 'pair_overflow', 'triplet_overflow',
              'disp_pair_overflow'):
        if k in dj:
            assert int(dt[k]) == int(dj[k]), k


def test_golden_total(evaluated):
    name, _, (et, _, _, _) = evaluated
    golden, tol = GOLDEN_KCAL[name]
    assert abs(et / 4.184 - golden) < tol


def test_not_ported_options_raise():
    sys_ = System.waters(3, box=[1.9] * 3)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        MBPol(sys_, MBPolConfig(nonbonded_method='PME', electrostatics_mode='sparse'),
              device='cpu')
    # above the CPU's dense limit 'auto' picks the sparse mode, not ported
    big = System.waters(600, box=[_side(600)] * 3)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        MBPol(big, MBPolConfig(nonbonded_method='PME'), device='cpu')


def test_default_device_needs_a_card():
    """MBPol runs on the card unless the caller asks for the CPU: without a
    card the default raises, nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MBPol(System.waters(3, box=[1.9] * 3), MBPolConfig(nonbonded_method='PME'))


def test_entry_points_take_numpy_and_move_to_the_device():
    d = fixtures.load('water14')
    tsys = System.from_atom_names(d['names'], d['resnames'], box=[1.8] * 3)
    pot = MBPol(tsys, MBPolConfig(nonbonded_method='PME', cutoff=0.9), device='cpu')
    pos = np.array(d['positions'])
    e_np, f_np, _, _ = pot.energy_forces(pos)
    e_t, f_t, _, _ = pot.energy_forces(torch.as_tensor(pos, dtype=torch.float32))
    assert f_np.dtype == f_t.dtype == torch.float64 and f_np.device.type == 'cpu'
    assert abs(float(e_np) - float(e_t)) < 1e-3
    sim = Simulation(MBPol(tsys, MBPolConfig.for_dynamics(), device='cpu'))
    sim.set_positions(pos)
    assert sim.state.positions.dtype == torch.float64


def _side(n_waters):
    """Box edge (nm) of a cube of n_waters at liquid density."""
    return (n_waters / 33.4) ** (1.0 / 3.0)


@pytest.mark.parametrize('n_waters', [512, 513, 2560, 2561])
@pytest.mark.parametrize('kernels', [False, True])
def test_auto_modes_match_jax(n_waters, kernels, monkeypatch):
    """'auto' resolution (construction only): the JAX MBPol with the Pallas
    kernels eligible (MBPOL_ELEC_PALLAS=1) or not, against the port's
    resolve_modes with the CUDA kernels eligible (a card) or not; the port's
    CPU MBPol resolves as the no-kernel column."""
    from mbpol_openmm_plugin_tpu.system import System as JSystem
    from mbpol_openmm_plugin_tpu_torch.models.potential import resolve_modes
    box = [_side(n_waters)] * 3
    cfg = dict(nonbonded_method='PME', cutoff=0.9)
    monkeypatch.setenv('MBPOL_ELEC_PALLAS', '1' if kernels else '0')
    jpot = JMBPol(JSystem.waters(n_waters, box=box), JConfig(**cfg))
    tsys = System.waters(n_waters, box=box)
    got = resolve_modes(tsys, MBPolConfig(**cfg), has_pme=True, kernels=kernels)
    assert got == (jpot.elec_mode, jpot.disp_mode)
    assert got[0] == ('dense' if n_waters <= (2560 if kernels else 512)
                      else 'block' if kernels else 'sparse')
    assert got[1] == ('dense' if got[0] == 'dense' else 'pairs')
    if not kernels:
        if got[0] == 'sparse':
            with pytest.raises(NotImplementedError, match='ROADMAP'):
                MBPol(tsys, MBPolConfig(**cfg), device='cpu')
        else:
            assert MBPol(tsys, MBPolConfig(**cfg), device='cpu').elec_mode == got[0]


def test_tune_capacities_matches_jax():
    """water256, for_dynamics() in block/pairs mode: the tuned pair,
    triplet and dispersion-pair capacities, the triplet-build shape
    parameters, the serpentine site sort and the tile-pair capacity."""
    box = [19.3996888399961804 / 10.0] * 3
    jsys, pos = fixtures.load_system('water256_integration_test', box=box)
    jpot = JMBPol(jsys, JConfig.for_dynamics(**BLOCK)).tune_capacities(pos)
    d = fixtures.load('water256_integration_test')
    tsys = System.from_atom_names(d['names'], d['resnames'], box=box)
    tpot = MBPol(tsys, MBPolConfig.for_dynamics(**BLOCK), device='cpu')
    tpot.tune_capacities(np.asarray(pos))
    for name in ('pair_cap', 'trip_cap', 'nlist_k_max', 'nlist_kt', 'disp_pair_cap'):
        assert getattr(tpot, name) == getattr(jpot, name), name
    np.testing.assert_array_equal(tpot._block_info['site_perm'], jpot._block_info['site_perm'])
    assert (tpot._block_info['tile_pair_capacity']
            == jpot._block_info['tile_pair_capacity'])
