"""List compaction (MBPolConfig.compact_eval; ops/neighbors.compact_pairs /
compact_triplets) and the reference's triplet enumeration
(triplet_semantics='reference') in the port, CPU float64, water50 (box
1.8 nm).

(a) compact_pairs / compact_triplets against the JAX functions: the same
    entries, masks and counts, exactly (a skin-inflated list compacted to
    the physical cutoff, and a capacity that overflows).
(b) triplet_list(semantics='reference') against the JAX list, exactly, and
    the water50 three-body energies under both semantics pinned as in
    tests/test_three_body.py (the 1.2847 kcal/mol the reference misses).
(c) MBPol under compact_eval=True and 'rebuild' (skin 0.05 nm) against the
    JAX MBPol under the same config: energy rtol 1e-9, forces atol 1e-8
    kJ/mol/nm, the same compaction diagnostics; and against the port's
    uncompacted evaluation.
(d) a 10-step Simulation under 'rebuild' with the 'auto' trigger against
    the JAX Simulation's compiled chunk (_step_chunk): per-step potential
    energy within 1e-8 kJ/mol (1e-11 relative), positions within 1e-10 nm.
(e) the compacted MD step (True and 'rebuild') under the host-read guard
    of tests/test_torch_step_capture.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu.md.simulation import Simulation as JSimulation
from mbpol_openmm_plugin_tpu.md.simulation import SimulationConfig as JSimConfig
from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
from mbpol_openmm_plugin_tpu.models.three_body import three_body_energy as j_three_body
from mbpol_openmm_plugin_tpu.ops import neighbors as JN
from mbpol_openmm_plugin_tpu.system import make_molecules_whole
from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.models.three_body import three_body_energy
from mbpol_openmm_plugin_tpu_torch.ops import neighbors as N
from mbpol_openmm_plugin_tpu_torch.system import System
from test_torch_step_capture import guard  # noqa: F401  (the host-read guard fixture)

torch.set_num_threads(1)

BOX = [1.8] * 3
KCAL = 1.0 / 4.184
TERMS = ('one_body', 'two_body', 'three_body', 'dispersion', 'electrostatics')


@pytest.fixture(scope='module')
def water50():
    """(JAX System, port System, whole positions with M sites placed)."""
    jsys, pos = fixtures.load_system('water50', box=BOX)
    pos = np.array(make_molecules_whole(jsys, pos))
    d = fixtures.load('water50')
    return jsys, System.from_atom_names(d['names'], d['resnames'], box=BOX), pos


def _o(jsys, pos):
    o = pos[np.asarray(jsys.o_index)]
    return jnp.asarray(o), torch.as_tensor(o)


@pytest.mark.parametrize('capacity', [300, 40])
def test_compact_pairs_matches_jax(water50, capacity):
    jsys, _, pos = water50
    jo, to = _o(jsys, pos)
    pairs, mask, _ = JN.pair_list(jo, BOX, 0.7, 400)
    jp, jm, jn = JN.compact_pairs(jo, BOX, pairs, mask, 0.65, 0.2, capacity)
    tp, tm, tn = N.compact_pairs(to, BOX, torch.as_tensor(np.array(pairs), dtype=torch.int64),
                                 torch.as_tensor(np.array(mask)), 0.65, 0.2, capacity)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int(tn) == int(jn) and (int(tn) > capacity) == (capacity == 40)


@pytest.mark.parametrize('capacity', [300, 60])
def test_compact_triplets_matches_jax(water50, capacity):
    jsys, _, pos = water50
    jo, to = _o(jsys, pos)
    trips, mask, _ = JN.triplet_list(jo, BOX, 0.5, 500)
    jt, jm, jn = JN.compact_triplets(jo, BOX, trips, mask, 0.45, 0.2, capacity)
    tt, tm, tn = N.compact_triplets(to, BOX, torch.as_tensor(np.array(trips), dtype=torch.int64),
                                    torch.as_tensor(np.array(mask)), 0.45, 0.2, capacity)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int(tn) == int(jn) and (int(tn) > capacity) == (capacity == 60)


def test_reference_triplets_match_jax(water50):
    jsys, tsys, pos = water50
    jo, to = _o(jsys, pos)
    cutoff = 0.45
    cap = JN.triplet_capacity(50, BOX, cutoff)
    vals = {}
    for sem in ('complete', 'reference'):
        jt, jm, jn = JN.triplet_list(jo, BOX, cutoff, cap, semantics=sem)
        tt, tm, tn = N.triplet_list(to, BOX, cutoff, cap, semantics=sem)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        assert int(tn) == int(jn) <= cap
        e = three_body_energy(tsys, torch.as_tensor(pos), tt, tm, box=BOX)
        ej = j_three_body(jsys, jnp.asarray(pos), jt, jm, box=jnp.asarray(BOX))
        assert abs(float(e) - float(ej)) <= 1e-9
        vals[sem] = float(e) * KCAL
    assert abs(vals['complete'] - 3.848850) < 1e-4, vals
    assert abs(vals['reference'] - 2.564164) < 1e-4, vals
    assert abs((vals['complete'] - vals['reference']) - 1.284686) < 1e-4


def test_reference_semantics_turns_compaction_off(water50):
    _, tsys, _ = water50
    pot = MBPol(tsys, MBPolConfig.for_dynamics(triplet_semantics='reference', compact_eval=True),
                device='cpu')
    assert pot.compact_eval is False
    with pytest.raises(ValueError, match='compact_eval'):
        MBPol(tsys, MBPolConfig.for_dynamics(compact_eval='sometimes'), device='cpu')
    with pytest.raises(ValueError, match='triplet_semantics'):
        MBPol(tsys, MBPolConfig.for_dynamics(triplet_semantics='partial'), device='cpu')


@pytest.mark.parametrize('ce', [True, 'rebuild'])
def test_compacted_mbpol_matches_jax(water50, ce):
    jsys, tsys, pos = water50
    cfg = dict(nonbonded_method='PME', cutoff=0.9, nlist_skin=0.05, compact_eval=ce,
               target_epsilon=1e-8)
    jpot = JMBPol(jsys, JConfig(**cfg))
    tpot = MBPol(tsys, MBPolConfig(**cfg), device='cpu')
    assert tpot.compact_eval == jpot.compact_eval == ce
    for name in ('pair_cap', 'trip_cap', 'pair_eval_cap', 'trip_eval_cap'):
        assert getattr(tpot, name) == getattr(jpot, name), name
    ej, fj, pj, dj = jpot.energy_forces(jnp.asarray(pos))
    et, ft, pt, dt = tpot.energy_forces(pos)
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-9)
    assert np.max(np.abs(ft.numpy() - np.asarray(fj))) <= 1e-8
    for k in TERMS:
        np.testing.assert_allclose(float(pt[k]), float(pj[k]), rtol=1e-9, atol=1e-9)
    assert set(k for k in dt if 'overflow' in k or k.startswith('n_')) == \
        set(k for k in dj if 'overflow' in k or k.startswith('n_'))
    for k in dj:
        if 'overflow' in k or k.startswith('n_'):
            assert int(dt[k]) == int(dj[k]), k
    # and the uncompacted evaluation: the dropped entries carry nothing
    plain = MBPol(tsys, MBPolConfig(**dict(cfg, compact_eval=None)), device='cpu')
    e0, f0, _, _ = plain.energy_forces(pos)
    np.testing.assert_allclose(float(et), float(e0), rtol=1e-12)
    assert float((ft - f0).abs().max()) <= 1e-9


def test_rebuild_simulation_matches_jax_step_chunk(water50):
    from mbpol_openmm_plugin_tpu.md import integrators as JI
    import jax
    jsys, tsys, pos = water50
    vel = np.array(JI.maxwell_boltzmann_velocities(jsys, 300.0, jax.random.PRNGKey(7)))
    n_steps = 10
    kw = dict(cutoff=0.85, nlist_skin=0.004, compact_eval='rebuild')
    scfg = dict(dt=0.0002, nlist_rebuild_interval='auto')
    jsim = JSimulation(JMBPol(jsys, JConfig.for_dynamics(**kw)), JSimConfig(**scfg))
    jsim.set_positions(jnp.asarray(pos))
    jsim.state = dataclasses.replace(jsim.state, velocities=jnp.asarray(vel))
    jstate, _, pe_j, _, ovf_j = jsim._step_chunk(jsim.state, None, n_steps=n_steps)

    pot = MBPol(tsys, MBPolConfig.for_dynamics(**kw), device='cpu')
    sim = Simulation(pot, SimulationConfig(**scfg))
    sim.set_positions(pos)
    sim.state = dataclasses.replace(sim.state, velocities=torch.as_tensor(vel))
    out = sim.step(n_steps)
    assert 1 <= sim.list_rebuilds < n_steps, sim.list_rebuilds
    assert not bool(ovf_j)
    ke = out['step_temperature'] * 3 * 3 * tsys.n_waters * 0.5 * 0.00831446261815324
    pe = out['step_total_energy'][1:] - ke
    # 1e-8 kJ/mol is 1e-11 of |E| (test_torch_step_capture.py's bounds)
    assert np.max(np.abs(pe - np.asarray(pe_j))) <= 1e-8
    assert np.max(np.abs(sim.state.positions.numpy() - np.asarray(jstate.positions))) <= 1e-10


@pytest.mark.parametrize('ce', [True, 'rebuild'])
def test_compacted_step_reads_nothing_on_the_host(water50, guard, ce):  # noqa: F811
    _, tsys, pos = water50
    pot = MBPol(tsys, MBPolConfig.for_dynamics(cutoff=0.85, nlist_skin=0.004, compact_eval=ce),
                device='cpu')
    sim = Simulation(pot, SimulationConfig(dt=0.0002, nlist_rebuild_interval='auto'))
    sim.set_positions(pos)
    sim.set_velocities_to_temperature(300.0)
    out = sim.step(3)
    assert len(guard) == 3 and np.all(np.isfinite(out['step_total_energy']))
