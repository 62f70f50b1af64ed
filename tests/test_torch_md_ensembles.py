"""The port's NVT/NPT drivers (md/integrators.py, md/minimize.py,
md/simulation.py) against the JAX package, CPU float64, water50 PME (box
1.8 nm, cutoff 0.85 nm). Each stochastic function gets the draws of the JAX
function's own key splits.

- remove_cm_motion, maxwell_boltzmann_velocities (sigma x the same
  normals) and andersen_thermostat: 1e-12.
- barostat_scale_update over a 40-move accept pattern: exact.
- One langevin_step: positions 1e-9 nm, energy 1e-8 kJ/mol.
- lbfgs_minimize: exact on a quadratic; 10 iterations on water50 give the
  JAX iteration count and positions within 1e-6 nm.
- Simulation for 10 steps against the JAX Simulation, NVE: with
  nlist_rebuild_interval=2 and cm_motion_interval=1 under the ASPC
  closure, and scf='keep' on a SOR potential; per-step potential energy and
  the final total energy within 1e-8 kJ/mol.
- Langevin at friction 0 and Andersen at frequency 0 equal Verlet;
  respa_mid > 1 with Langevin raises ValueError (RESPA itself is in
  test_torch_respa.py).

The barostat's move and an NPT checkpoint replay are in
test_torch_dynamic_box.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu.md import integrators as JI
from mbpol_openmm_plugin_tpu.md.minimize import lbfgs_minimize as jax_lbfgs
from mbpol_openmm_plugin_tpu.md.simulation import Simulation as JSimulation
from mbpol_openmm_plugin_tpu.md.simulation import SimulationConfig as JSimConfig
from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
from mbpol_openmm_plugin_tpu.system import make_molecules_whole
from mbpol_openmm_plugin_tpu_torch.md import integrators as I
from mbpol_openmm_plugin_tpu_torch.md.minimize import lbfgs_minimize
from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.system import System

torch.set_num_threads(1)

BOX = 1.8
CUTOFF = 0.85
T_K = 300.0
DT = 0.0002
CFG = dict(nonbonded_method='PME', cutoff=CUTOFF, target_epsilon=1e-7)


@pytest.fixture(scope='module')
def water50():
    """(port System, JAX System, whole positions numpy, MB velocities at
    300 K from the JAX key 7, the JAX converged evaluation jitted)."""
    jsys, pos = fixtures.load_system('water50', box=[BOX] * 3)
    pos = np.array(make_molecules_whole(jsys, pos))
    d = fixtures.load('water50')
    tsys = System.from_atom_names(d['names'], d['resnames'], box=[BOX] * 3)
    vel = np.array(JI.maxwell_boltzmann_velocities(jsys, T_K, jax.random.PRNGKey(7)))
    jpot = JMBPol(jsys, JConfig(**CFG))
    return tsys, jsys, pos, vel, jpot, jax.jit(jpot._energy_forces_impl)


def T(x):
    return torch.as_tensor(np.array(x))


def test_cm_removal_and_maxwell_boltzmann_match_jax(water50):
    tsys, jsys, _, vel, _, _ = water50
    np.testing.assert_allclose(I.remove_cm_motion(tsys, T(vel)).numpy(),
                               np.asarray(JI.remove_cm_motion(jsys, jnp.asarray(vel))),
                               rtol=0, atol=1e-12)
    key = jax.random.PRNGKey(3)
    normals = jax.random.normal(key, (tsys.n_atoms, 3), jnp.float64)
    np.testing.assert_allclose(
        I.maxwell_boltzmann_velocities(tsys, T_K, T(normals)).numpy(),
        np.asarray(JI.maxwell_boltzmann_velocities(jsys, T_K, key)), rtol=0, atol=1e-12)


def _jstate(jsys, pos, vel, e, f, key):
    return JI.MDState(positions=jnp.asarray(pos), velocities=jnp.asarray(vel),
                      forces=jnp.asarray(f), potential_energy=jnp.asarray(e),
                      box=jnp.asarray(jsys.box), step=jnp.zeros((), jnp.int32), rng=key)


def _tstate(tsys, pos, vel, e, f):
    return I.MDState(positions=T(pos), velocities=T(vel), forces=T(f),
                     potential_energy=torch.tensor(float(e), dtype=torch.float64),
                     box=np.array(tsys.box), step=0)


def test_andersen_matches_jax(water50):
    tsys, jsys, pos, vel, _, _ = water50
    key = jax.random.PRNGKey(11)
    zero = np.zeros_like(pos)
    # a high collision frequency, so that about half of the atoms collide
    freq = 3000.0
    js = JI.andersen_thermostat(jsys, _jstate(jsys, pos, vel, 0.0, zero, key), DT, T_K, freq)
    _, k1, k2 = jax.random.split(key, 3)
    u = jax.random.uniform(k1, (tsys.n_atoms,))
    normals = jax.random.normal(k2, (tsys.n_atoms, 3), jnp.float64)
    ts = I.andersen_thermostat(tsys, _tstate(tsys, pos, vel, 0.0, zero), DT, T_K, freq,
                               T(u), T(normals))
    changed = np.any(np.asarray(js.velocities) != vel, axis=1)
    assert 0 < changed.sum() < 3 * tsys.n_waters
    np.testing.assert_allclose(ts.velocities.numpy(), np.asarray(js.velocities), rtol=0,
                               atol=1e-12)


def test_barostat_scale_update_matches_jax():
    rng = np.random.default_rng(5)
    # runs of accepts and rejects, so that the scale both grows and shrinks
    pattern = np.concatenate([np.ones(12), np.zeros(14), rng.random(14) < 0.5]).astype(bool)
    box = np.full(3, BOX)
    jb = JI.barostat_scale_init(jnp.asarray(box))
    tb = I.barostat_scale_init(box)
    volume = float(np.prod(box))
    fired = 0
    for acc in pattern:
        jb = JI.barostat_scale_update(jb, jnp.asarray(acc), jnp.asarray(volume))
        new = I.barostat_scale_update(tb, acc, volume)
        fired += new[0] != tb[0]
        tb = new
        assert (tb[0], tb[1], tb[2]) == (float(jb[0]), int(jb[1]), int(jb[2]))
    assert fired >= 2


def test_langevin_step_matches_jax(water50):
    tsys, jsys, pos, vel, _, jef = water50
    e0, f0, _, _ = jef(jnp.asarray(pos))
    key = jax.random.PRNGKey(2)
    friction = 50.0
    js = JI.langevin_step(jsys, lambda p: jef(p)[:2], _jstate(jsys, pos, vel, e0, f0, key),
                          DT, T_K, friction)
    noise = jax.random.normal(jax.random.split(key)[1], pos.shape, jnp.float64)
    pot = MBPol(tsys, MBPolConfig(**CFG), device='cpu')
    ts = I.langevin_step(tsys, lambda p: pot._energy_forces_impl(p)[:2],
                         _tstate(tsys, pos, vel, e0, f0), DT, T_K, friction, T(noise))
    assert np.max(np.abs(ts.positions.numpy() - np.asarray(js.positions))) <= 1e-9
    assert abs(float(ts.potential_energy) - float(js.potential_energy)) <= 1e-8
    assert ts.step == 1


def test_lbfgs_quadratic_exact():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(12, 12))
    A = A @ A.T + 12 * np.eye(12)
    b = rng.normal(size=12)
    x_star = np.linalg.solve(A, b)
    At, bt = T(A), T(b)

    def eg(x):
        xf = x.reshape(-1)
        return 0.5 * xf @ At @ xf - bt @ xf, (At @ xf - bt).reshape(x.shape)

    x, _, diag = lbfgs_minimize(eg, torch.zeros((4, 3), dtype=torch.float64),
                                max_iterations=100, tolerance=1e-8)
    np.testing.assert_allclose(x.numpy().reshape(-1), x_star, atol=1e-5)
    assert diag['converged']
    assert all(b <= a for a, b in zip(diag['energies'], diag['energies'][1:]))


def test_lbfgs_water50_matches_jax(water50):
    tsys, _, pos, _, _, jef = water50

    def jeg(p):
        e, f, _, _ = jef(p)
        return e, -f

    pot = MBPol(tsys, MBPolConfig(**CFG), device='cpu')

    def teg(p):
        e, f, _, _ = pot._energy_forces_impl(p)
        return e, -f

    xj, ej, dj = jax_lbfgs(jeg, jnp.asarray(pos), max_iterations=10, tolerance=1e-3)
    xt, et, dt = lbfgs_minimize(teg, T(pos), max_iterations=10, tolerance=1e-3)
    assert dt['iterations'] == int(dj['iterations']) == 10
    assert np.max(np.abs(xt.numpy() - np.asarray(xj))) <= 1e-6
    assert float(et) < dt['energies'][0]


def _jax_nve(jsys, jconfig, scfg, pos, vel, n_steps):
    """The JAX Simulation's chunk of n_steps: (per-step PE, final E_tot)."""
    sim = JSimulation(JMBPol(jsys, jconfig), scfg)
    sim.set_positions(jnp.asarray(pos))
    sim.state = dataclasses.replace(sim.state, velocities=jnp.asarray(vel))
    state, _, pes, ke, _ = sim._step_chunk(sim.state, None, n_steps=n_steps)
    return np.asarray(pes), float(pes[-1]) + float(ke)


@pytest.mark.parametrize('case', ['interval2_cm', 'keep_sor'])
def test_simulation_matches_jax(water50, case):
    tsys, jsys, pos, vel, _, _ = water50
    n_steps = 10
    if case == 'interval2_cm':
        kw = dict(cutoff=CUTOFF)
        jcfg, tcfg = JConfig.for_dynamics(**kw), MBPolConfig.for_dynamics(**kw)
        scfg = dict(dt=DT, nlist_rebuild_interval=2, cm_motion_interval=1)
    else:
        jcfg, tcfg = JConfig(**CFG), MBPolConfig(**CFG)
        scfg = dict(dt=DT, scf='keep')
    pe_j, etot_j = _jax_nve(jsys, jcfg, JSimConfig(**scfg), pos, vel, n_steps)
    sim = Simulation(MBPol(tsys, tcfg, device='cpu'), SimulationConfig(**scfg))
    assert sim.potential.config.scf_method == tcfg.scf_method
    sim.set_positions(pos)
    sim.state = dataclasses.replace(sim.state, velocities=T(vel))
    out = sim.step(n_steps)
    ndof = 3 * 3 * tsys.n_waters
    ke = out['step_temperature'] * ndof * 0.5 * 0.00831446261815324
    pe_t = out['step_total_energy'][1:] - ke
    assert np.max(np.abs(pe_t - pe_j)) <= 1e-8
    assert abs(out['total_energy'][-1] - etot_j) <= 1e-8


def _short_run(tsys, pos, scfg, n_steps):
    sim = Simulation(MBPol(tsys, MBPolConfig.for_dynamics(cutoff=CUTOFF), device='cpu'),
                     scfg, seed=4)
    sim.set_positions(pos)
    sim.set_velocities_to_temperature(T_K)
    sim.step(n_steps)
    return sim.state


def test_zero_friction_and_zero_collisions_equal_verlet(water50):
    tsys, _, pos, _, _, _ = water50
    n = 3
    verlet = _short_run(tsys, pos, SimulationConfig(dt=DT, nlist_rebuild_interval='auto'), n)
    nvt = dict(dt=DT, nlist_rebuild_interval='auto', temperature=T_K)
    andersen = _short_run(tsys, pos, SimulationConfig(thermostat='andersen',
                                                      collision_frequency=0.0, **nvt), n)
    assert torch.equal(andersen.positions, verlet.positions)
    assert torch.equal(andersen.velocities, verlet.velocities)
    langevin = _short_run(tsys, pos, SimulationConfig(thermostat='langevin', friction=0.0,
                                                      **nvt), n)
    assert float((langevin.positions - verlet.positions).abs().max()) <= 1e-12
    assert float((langevin.velocities - verlet.velocities).abs().max()) <= 1e-9


def test_respa_raises(water50):
    """respa_mid > 1 runs velocity Verlet only: with Langevin it raises, as
    the JAX Simulation does."""
    tsys = water50[0]
    pot = MBPol(tsys, MBPolConfig.for_dynamics(cutoff=CUTOFF), device='cpu')
    with pytest.raises(ValueError, match='respa_mid'):
        Simulation(pot, SimulationConfig(respa_mid=3, temperature=T_K, thermostat='langevin'))
    Simulation(pot, SimulationConfig(respa_inner=2, temperature=T_K, thermostat='langevin'))
