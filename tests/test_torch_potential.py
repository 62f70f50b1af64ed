"""The port's MBPol.energy_forces against the JAX MBPol, CPU float64, on
water14 and water50 PME (cutoff 0.9 nm, box 1.8 nm), with the JAX
potential's parameters, PME setup and list capacities carried across by
convert.from_jax_arrays. Bounds: |dE| <= 1e-6 kJ/mol per term, max |dF| <=
1e-6 kJ/mol/nm, equal SCF iteration counts; plus the reference golden
totals of test_potential_pme.py.
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

GOLDEN_KCAL = {'water14': (-60.0, 1.0), 'water50': (-244.37507, 1.0)}
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
    return out


@pytest.fixture(scope='module', params=['water14', 'water50'])
def evaluated(request):
    name = request.param
    box = [1.8] * 3
    jsys, pos = fixtures.load_system(name, box=box)
    jpot = JMBPol(jsys, JConfig(nonbonded_method='PME', cutoff=0.9))
    ej, fj, pj, dj = jpot.energy_forces(pos)
    d = fixtures.load(name)
    tsys = System.from_atom_names(d['names'], d['resnames'], box=box)
    tpot = convert.from_jax_arrays(tsys, MBPolConfig(nonbonded_method='PME', cutoff=0.9),
                                   **jax_arrays(jpot))
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
    for k in ('n_pairs', 'n_triplets', 'pair_overflow', 'triplet_overflow'):
        if k in dj:
            assert int(dt[k]) == int(dj[k]), k


def test_golden_total(evaluated):
    name, _, (et, _, _, _) = evaluated
    golden, tol = GOLDEN_KCAL[name]
    assert abs(et / 4.184 - golden) < tol


def test_not_ported_options_raise():
    sys_ = System.waters(3, box=[1.9] * 3)
    for cfg in (dict(electrostatics_mode='block'), dict(electrostatics_mode='sparse'),
                dict(dispersion_mode='pairs'), dict(scf_method='diis')):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            MBPol(sys_, MBPolConfig(nonbonded_method='PME', **cfg))
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        MBPol(System.waters(3), MBPolConfig(nonbonded_method='NoCutoff'))
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        MBPol(System.waters(3, n_ions=1, box=[1.9] * 3),
              MBPolConfig(nonbonded_method='PME', terms=('one_body', 'dispersion')))
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        Simulation(MBPol(sys_, MBPolConfig.for_dynamics()),
                   SimulationConfig(temperature=300.0))
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        Simulation(MBPol(sys_, MBPolConfig(nonbonded_method='PME')))   # per-step SOR
