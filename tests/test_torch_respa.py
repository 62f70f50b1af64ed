"""The port's r-RESPA (md/integrators.py, md/rpmd.py, md/simulation.py)
against the JAX package, CPU float64, on the water3 cluster and water50 PME
(box 1.8 nm, cutoff 0.85 nm). Stochastic steps get the draws of the JAX
function's own key splits.

- One and two steps of respa_velocity_verlet_step and respa_langevin_step
  on water50 PME (inner 2), and of respa3_velocity_verlet_step on water3
  (mid 2, inner 2), against the JAX step with the same rungs: positions
  1e-12 nm, velocities 1e-9 nm/ps, energy 1e-8 kJ/mol.
- An empty fast channel with n_inner = 1 is velocity Verlet, bit for bit.
- The split energies and forces of a RESPA Simulation (two-level,
  three-level 'mid' and 'inner', cold SCF) rebuild the full potential at
  its positions: energy 1e-10 relative, forces 1e-8 kJ/mol/nm.
- A 10-outer-step Simulation against the JAX _step_chunk where one group
  covers the segment (two-level Verlet, two-level Langevin, three-level
  'mid'; ASPC closure): per-step potential energy 1e-8 kJ/mol, positions
  1e-12 nm.
- The carry: three-level RESPA under 'inner' and 'mid', 10 outer steps with
  nlist_rebuild_interval=2 (five groups) against 1 (one group): positions,
  velocities and per-step energies within 1e-12. water3 builds no lists, so
  both runs evaluate the same terms in the same order and only the group
  boundaries differ. (The JAX package re-seeds the rung forces at each
  group; ROADMAP.md section 3 records its gap.)
- A checkpoint replay bit for bit (two-level Langevin; three-level 'inner'
  with Andersen), the rung forces carried in the checkpoint.
- Two-level RESPA under the barostat (water50, three moves, accepted and
  rejected): the carried forces are dropped at an accepted move and kept,
  equal to the state's, at a rejected one (no JAX parity).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu.md import integrators as JI
from mbpol_openmm_plugin_tpu.md.rpmd import mbpol_intra_inter_split as jax_split
from mbpol_openmm_plugin_tpu.md.simulation import Simulation as JSimulation
from mbpol_openmm_plugin_tpu.md.simulation import SimulationConfig as JSimConfig
from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
from mbpol_openmm_plugin_tpu.system import make_molecules_whole
from mbpol_openmm_plugin_tpu_torch.md import integrators as I
from mbpol_openmm_plugin_tpu_torch.md.rpmd import mbpol_intra_inter_split
from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.system import System

torch.set_num_threads(1)

T_K = 300.0
CLUSTER = dict(nonbonded_method='NoCutoff', cutoff=0.9)
PME = dict(nonbonded_method='PME', cutoff=0.85, target_epsilon=1e-7)


def T(x):
    return torch.as_tensor(np.array(x))


def systems(name, box=None):
    jsys, pos = fixtures.load_system(name, box=box)
    pos = np.array(make_molecules_whole(jsys, pos))
    d = fixtures.load(name)
    tsys = System.from_atom_names(d['names'], d['resnames'], box=box)
    vel = np.array(JI.maxwell_boltzmann_velocities(jsys, T_K, jax.random.PRNGKey(7)))
    return jsys, tsys, pos, vel


@pytest.fixture(scope='module')
def water3():
    return systems('water3')


@pytest.fixture(scope='module')
def water50():
    """water50 PME with both packages' intra/inter splits (JAX inter jitted)."""
    jsys, tsys, pos, vel = systems('water50', box=[1.8] * 3)
    j_intra, j_inter = jax_split(JMBPol(jsys, JConfig(**PME)))
    t_intra, t_inter = mbpol_intra_inter_split(MBPol(tsys, MBPolConfig(**PME), device='cpu'))
    j_slow = jax.jit(lambda p: j_inter._potential._energy_forces_impl(p)[:2])
    return jsys, tsys, pos, vel, (j_intra, j_slow), (t_intra, t_inter)


def jax_state(jsys, pos, vel, e, f, key):
    return JI.MDState(positions=jnp.asarray(pos), velocities=jnp.asarray(vel),
                      forces=jnp.asarray(f), potential_energy=jnp.asarray(e),
                      box=jnp.asarray(jsys.box if jsys.box is not None else np.zeros(3)),
                      step=jnp.zeros((), jnp.int32), rng=key)


def port_state(tsys, pos, vel, e, f):
    return I.MDState(positions=T(pos), velocities=T(vel), forces=T(f),
                     potential_energy=torch.tensor(float(e), dtype=torch.float64),
                     box=None if tsys.box is None else np.array(tsys.box), step=0)


def jax_noises(key, n_inner, shape):
    """The normals respa_langevin_step draws from state.rng = key, and the
    key it leaves in the state."""
    key, knoise = jax.random.split(key)
    ks = jax.random.split(knoise, n_inner)
    return key, T(np.stack([np.asarray(jax.random.normal(k, shape, jnp.float64)) for k in ks]))


def assert_states(ts, js):
    assert np.max(np.abs(ts.positions.numpy() - np.asarray(js.positions))) <= 1e-12
    assert np.max(np.abs(ts.velocities.numpy() - np.asarray(js.velocities))) <= 1e-9
    assert abs(float(ts.potential_energy) - float(js.potential_energy)) <= 1e-8


@pytest.mark.parametrize('kind', ['verlet', 'langevin'])
def test_two_level_step_matches_jax(water50, kind):
    jsys, tsys, pos, vel, (j_intra, j_slow), (t_intra, t_inter) = water50
    dt, n_inner, friction = 0.0004, 2, 50.0
    e0, fs = j_slow(jnp.asarray(pos))
    key = jax.random.PRNGKey(2)
    js = jax_state(jsys, pos, vel, e0, fs, key)
    ts = port_state(tsys, pos, vel, e0, fs)
    jfs, tfs, tff = fs, T(fs), None

    def t_slow(p):
        return t_inter._energy_forces_impl(p)[:2]

    for _ in range(2):
        if kind == 'verlet':
            js, jfs, _ = JI.respa_velocity_verlet_step(jsys, j_intra, j_slow, js, jfs, dt, n_inner)
            ts, tfs, tff = I.respa_velocity_verlet_step(tsys, t_intra, t_slow, ts, tfs, dt,
                                                        n_inner, f_fast=tff)
        else:
            key, noises = jax_noises(js.rng, n_inner, pos.shape)
            js, jfs, _ = JI.respa_langevin_step(jsys, j_intra, j_slow, js, jfs, dt, n_inner,
                                                T_K, friction)
            assert bool(jnp.all(js.rng == key))
            ts, tfs, tff = I.respa_langevin_step(tsys, t_intra, t_slow, ts, tfs, dt, n_inner,
                                                 T_K, friction, noises, f_fast=tff)
        assert_states(ts, js)
    assert ts.step == 2


def term_pots(jsys, tsys, terms):
    cfg = dict(CLUSTER, terms=terms)
    jpot = JMBPol(jsys, JConfig(**cfg))
    tpot = MBPol(tsys, MBPolConfig(**cfg), device='cpu')
    return (jax.jit(lambda p: jpot._energy_forces_impl(p)[:2]),
            lambda p: tpot._energy_forces_impl(p)[:2])


def test_three_level_step_matches_jax(water3):
    jsys, tsys, pos, vel = water3
    j_intra, _ = jax_split(JMBPol(jsys, JConfig(**CLUSTER)))
    t_intra, _ = mbpol_intra_inter_split(MBPol(tsys, MBPolConfig(**CLUSTER), device='cpu'))
    j_mid, t_mid = term_pots(jsys, tsys, ('two_body', 'dispersion', 'electrostatics'))
    j_slow, t_slow = term_pots(jsys, tsys, ('three_body',))
    _, f_mid = j_mid(jnp.asarray(pos))
    e0, f_slow = j_slow(jnp.asarray(pos))
    js = jax_state(jsys, pos, vel, e0, f_slow, jax.random.PRNGKey(0))
    ts = port_state(tsys, pos, vel, e0, f_slow)
    jm, jsl, tm, tsl, tff = f_mid, f_slow, T(f_mid), T(f_slow), None
    for _ in range(2):
        js, jm, jsl, _ = JI.respa3_velocity_verlet_step(jsys, j_intra, j_mid, j_slow, js, jm,
                                                        jsl, 0.0008, 2, 2)
        ts, tm, tsl, tff = I.respa3_velocity_verlet_step(tsys, t_intra, t_mid, t_slow, ts, tm,
                                                         tsl, 0.0008, 2, 2, f_fast=tff)
        assert_states(ts, js)


def test_empty_fast_channel_is_verlet(water3):
    _, tsys, pos, vel = water3
    pot = MBPol(tsys, MBPolConfig(**CLUSTER), device='cpu')

    def ef(p):
        return pot._energy_forces_impl(p)[:2]

    def ef_zero(p):
        return torch.zeros((), dtype=p.dtype), torch.zeros_like(p)

    e0, f0 = ef(T(pos))
    s_vv = s_mts = port_state(tsys, pos, vel, e0, f0)
    f_slow = f0
    for _ in range(5):
        s_vv = I.velocity_verlet_step(tsys, ef, s_vv, 0.0002)
        s_mts, f_slow, _ = I.respa_velocity_verlet_step(tsys, ef_zero, ef, s_mts, f_slow,
                                                        0.0002, 1)
    for name in ('positions', 'velocities', 'forces', 'potential_energy'):
        assert torch.equal(getattr(s_mts, name), getattr(s_vv, name)), name


RESPA_CASES = {'two_level': dict(dt=0.0004, respa_inner=2),
               'mid': dict(dt=0.0008, respa_inner=2, respa_mid=2),
               'inner': dict(dt=0.0008, respa_inner=2, respa_mid=2,
                             respa_polarization_rung='inner')}


def port_sim(tsys, pos, vel, seed=1, **scfg):
    sim = Simulation(MBPol(tsys, MBPolConfig(**CLUSTER), device='cpu'),
                     SimulationConfig(**scfg), seed=seed)
    sim.set_positions(pos)
    sim.state = dataclasses.replace(sim.state, velocities=T(vel))
    return sim


@pytest.mark.parametrize('case', list(RESPA_CASES))
def test_split_energies_rebuild_the_full_potential(water3, case):
    _, tsys, pos, vel = water3
    sim = port_sim(tsys, pos, vel, scf_warm_start=False, **RESPA_CASES[case])
    sim.step(3)
    e, f, _, _ = sim.potential.energy_forces(sim.state.positions)
    assert abs(float(sim.state.potential_energy) - float(e)) <= 1e-10 * abs(float(e))
    assert float((sim.state.forces - f).abs().max()) <= 1e-8


def pe_per_step(out, tsys):
    ndof = 3 * 3 * tsys.n_waters
    ke = out['step_temperature'] * ndof * 0.5 * 0.00831446261815324
    return out['step_total_energy'][1:] - ke


@pytest.mark.parametrize('case', ['two_level', 'langevin', 'mid'])
def test_simulation_matches_jax_one_group(water3, case):
    jsys, tsys, pos, vel = water3
    n_steps, seed = 10, 3
    scfg = (dict(RESPA_CASES['two_level'], temperature=T_K, thermostat='langevin',
                 friction=100.0) if case == 'langevin' else RESPA_CASES[case])
    jsim = JSimulation(JMBPol(jsys, JConfig(**CLUSTER)), JSimConfig(**scfg), seed=seed)
    jsim.set_positions(jnp.asarray(pos))
    jsim.state = dataclasses.replace(jsim.state, velocities=jnp.asarray(vel))
    jstate, _, pe_j, _, _ = jsim._step_chunk(jsim.state, None, n_steps=n_steps)

    sim = port_sim(tsys, pos, vel, seed=seed, **scfg)
    assert sim.potential.config.scf_method == 'aspc'
    assert sim.potential.config.aspc_n_corr == (2 if case == 'mid' else 1)
    if case == 'langevin':
        key = [jax.random.PRNGKey(seed)]

        def normal(shape):
            key[0], noises = jax_noises(key[0], 2, pos.shape)
            assert tuple(noises.shape) == tuple(shape)
            return noises
        sim._normal = normal
    out = sim.step(n_steps)
    assert np.max(np.abs(pe_per_step(out, tsys) - np.asarray(pe_j))) <= 1e-8
    assert np.max(np.abs(sim.state.positions.numpy() - np.asarray(jstate.positions))) <= 1e-12


@pytest.mark.parametrize('rung', ['inner', 'mid'])
def test_group_boundaries_change_nothing(water3, rung):
    _, tsys, pos, vel = water3
    runs = []
    for interval in (2, 1):
        sim = port_sim(tsys, pos, vel, nlist_rebuild_interval=interval, **RESPA_CASES[rung])
        out = sim.step(10)
        runs.append((sim.state, out['step_total_energy']))
    (a, ea), (b, eb) = runs
    assert float((a.positions - b.positions).abs().max()) <= 1e-12
    assert float((a.velocities - b.velocities).abs().max()) <= 1e-12
    assert np.max(np.abs(ea - eb)) <= 1e-12


@pytest.mark.parametrize('case', ['langevin', 'inner_andersen'])
def test_checkpoint_replay_bit_for_bit(water3, tmp_path, case):
    _, tsys, pos, vel = water3
    scfg = (dict(RESPA_CASES['two_level'], thermostat='langevin') if case == 'langevin'
            else dict(RESPA_CASES['inner'], thermostat='andersen', collision_frequency=500.0))
    scfg['temperature'] = T_K
    a = port_sim(tsys, pos, vel, **scfg)
    a.step(10, report_interval=5)
    b = port_sim(tsys, pos, vel, **scfg)
    b.step(5)
    path = str(tmp_path / 'respa.npz')
    b.save_checkpoint(path)
    assert 'respa_fast' in np.load(path).files
    c = Simulation(b.potential, b.config, seed=0)
    c.load_checkpoint_file(path)
    c.step(5)
    for name in ('positions', 'velocities', 'forces', 'potential_energy'):
        assert torch.equal(getattr(a.state, name), getattr(c.state, name)), name


def test_respa_under_the_barostat(water50):
    """Two-level RESPA under the MC barostat (water50 PME, a move after every
    2 outer steps; 1e5 bar, so that the moves of this dilute box are
    sometimes rejected): the moves run; an accepted move leaves the carried rung
    forces invalid (the next group evaluates them afresh), a rejected one
    leaves them those of the state, summing to its forces."""
    _, tsys, pos, vel, _, _ = water50
    sim = Simulation(MBPol(tsys, MBPolConfig.for_dynamics(cutoff=0.85), device='cpu'),
                     SimulationConfig(dt=0.0004, respa_inner=2, temperature=T_K,
                                      thermostat='langevin', barostat_pressure=1e5,
                                      barostat_interval=2), seed=2)
    sim.set_positions(pos)
    sim.state = dataclasses.replace(sim.state, velocities=T(vel))
    accepted = []
    for _ in range(3):
        out = sim.step(2)
        assert out['barostat_attempted'] == 1
        assert np.all(np.isfinite(out['step_total_energy']))
        accepted.append(out['barostat_accepted'])
        assert sim._respa_carry_valid(sim.state) == (not accepted[-1])
        if not accepted[-1]:
            f = sim._respa_f
            assert torch.equal(sim.state.forces, f['slow'] + f['fast'])
    assert 0 < sum(accepted) < 3, accepted
