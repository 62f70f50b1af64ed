"""The port's replica exchange (mbpol_openmm_plugin_tpu_torch/md/remd.py) and
replica evaluation (md/replicas.py) against the JAX package's, CPU float64.

- exchange_permutation fed the JAX key's uniforms, apply_exchange,
  round_trip_stats and geometric_ladder: exact;
- replica_energy_forces on water3 at R = 3 against the JAX vmap: energies
  1e-9 kJ/mol, forces 1e-9 of max |F| (~2400 kJ/mol/nm; measured 1.6e-12);
- REMDSimulation on the water14 cluster (SOR, eps 1e-10, warm start), R = 4,
  2 blocks of 5 steps, fed the draws of the JAX key splits: per-block
  energies and final positions within 1e-8 kJ/mol and 1e-10 nm, the same
  accepts and walkers;
- a checkpoint resume bit for bit; the ladder's validation, the R = 1
  ladder, the cold-slot frame callback and the refusal of a mesh that is
  not a parallel.mesh.Mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu.md import integrators as JI
from mbpol_openmm_plugin_tpu.md import remd as JREMD
from mbpol_openmm_plugin_tpu.md.replicas import replica_energy_forces as j_replicas
from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
from mbpol_openmm_plugin_tpu.system import System as JSystem
from mbpol_openmm_plugin_tpu.system import compute_virtual_sites as jvsites
from mbpol_openmm_plugin_tpu_torch.md import integrators as I
from mbpol_openmm_plugin_tpu_torch.md import remd
from mbpol_openmm_plugin_tpu_torch.md.replicas import replica_energy_forces
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.system import System, compute_virtual_sites

torch.set_num_threads(1)

CLUSTER = dict(nonbonded_method='NoCutoff', target_epsilon=1e-10, max_iterations=500)
LADDER = [280.0, 320.0, 370.0, 420.0]


@pytest.mark.parametrize('R', [1, 2, 5, 6])
@pytest.mark.parametrize('parity', [0, 1])
def test_exchange_permutation_matches_jax(R, parity):
    rng = np.random.default_rng(10 * R + parity)
    pe = rng.normal(-500.0, 3.0, R)
    T = JREMD.geometric_ladder(280.0, 420.0, R) if R > 1 else np.array([300.0])
    key = jax.random.PRNGKey(R + 7 * parity)
    perm_j, acc_j = JREMD.exchange_permutation(jnp.asarray(pe), T, key, parity)
    u = np.asarray(jax.random.uniform(key, (R,), jnp.float64))
    perm, acc = remd.exchange_permutation(torch.as_tensor(pe), T, torch.as_tensor(u), parity)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_j))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))
    np.testing.assert_array_equal(perm.numpy()[perm.numpy()], np.arange(R))   # an involution


def test_apply_exchange_matches_jax():
    R, na = 4, 12
    rng = np.random.default_rng(2)
    f = {k: rng.standard_normal((R, na, 3)) for k in ('positions', 'velocities', 'forces')}
    pe = rng.standard_normal(R)
    perm = np.array([1, 0, 3, 2])
    T = JREMD.geometric_ladder(280.0, 420.0, R)
    jst = JI.MDState(positions=jnp.asarray(f['positions']),
                     velocities=jnp.asarray(f['velocities']), forces=jnp.asarray(f['forces']),
                     potential_energy=jnp.asarray(pe), box=jnp.zeros((R, 3)),
                     step=jnp.zeros((R,), jnp.int32), rng=jax.random.split(jax.random.PRNGKey(0),
                                                                           R))
    jnew = JREMD.apply_exchange(jst, jnp.asarray(perm), T)
    st = I.MDState(**{k: torch.as_tensor(v) for k, v in f.items()},
                   potential_energy=torch.as_tensor(pe))
    new = remd.apply_exchange(st, torch.as_tensor(perm), T)
    for k in ('positions', 'velocities', 'forces', 'potential_energy'):
        np.testing.assert_array_equal(getattr(new, k).numpy(), np.asarray(getattr(jnew, k)))


def test_round_trip_stats_and_ladder():
    rng = np.random.default_rng(4)
    R, walker, blocks = 4, np.arange(4), []
    for b in range(200):
        p = b % 2
        perm = np.arange(R)
        for i in range(p, R - 1, 2):
            if rng.random() < 0.6:
                perm[i], perm[i + 1] = i + 1, i
        walker = walker[perm]
        blocks.append(walker.copy())
    w = np.asarray(blocks)
    assert remd.round_trip_stats(w) == JREMD.round_trip_stats(w)
    assert remd.round_trip_stats(w)['round_trips_total'] > 0
    assert remd.round_trip_stats(w[:1]) == JREMD.round_trip_stats(w[:1])
    for args in ((280.0, 420.0, 5), (180.0, 480.0, 8), (300.0, 300.0, 1)):
        np.testing.assert_array_equal(remd.geometric_ladder(*args),
                                      JREMD.geometric_ladder(*args))


def test_replica_energy_forces_matches_jax_vmap():
    jsys, pos = fixtures.load_system('water3')
    cfg = dict(nonbonded_method='NoCutoff', cutoff=0.9, target_epsilon=1e-10)
    rng = np.random.default_rng(0)
    reps = np.stack([np.asarray(pos) + 0.002 * rng.standard_normal(pos.shape) for _ in range(3)])
    e_j, f_j, c_j = j_replicas(JMBPol(jsys, JConfig(**cfg)))(jnp.asarray(reps))
    pot = MBPol(System.waters(3), MBPolConfig(**cfg), device='cpu')
    e, f, c = replica_energy_forces(pot)(reps)
    assert e.shape == (3,) and f.shape == reps.shape and bool(c.all()) and bool(c_j.all())
    assert np.max(np.abs(e.numpy() - np.asarray(e_j))) <= 1e-9
    assert np.max(np.abs(f.numpy() - np.asarray(f_j))) <= 1e-9 * np.max(np.abs(f_j))


# ----------------------------------------------------------------------
# REMDSimulation against the JAX driver, fed the JAX draws
# ----------------------------------------------------------------------

@pytest.fixture(scope='module')
def water14():
    jsys = JSystem.waters(14)
    pos = np.asarray(jvsites(jsys, jnp.asarray(fixtures.load('water14_cluster')['positions'])))
    return (MBPol(System.waters(14), MBPolConfig(**CLUSTER), device='cpu'),
            JMBPol(jsys, JConfig(**CLUSTER)), pos)


def _feed_jax_draws(sim, seed):
    """Make sim draw what the JAX REMDSimulation draws: split(PRNGKey(seed),
    3) -> (exchange, init, velocity) keys; the Maxwell-Boltzmann normals of
    split(split(vel)[1], R); each step's normals from each replica's
    chain (split(init, R)); each sweep's uniforms [R] from the exchange
    chain."""
    R = len(sim.temperatures)
    exch, init, vel = jax.random.split(jax.random.PRNGKey(seed), 3)
    chain = dict(exch=exch, vel=vel, reps=list(jax.random.split(init, R)), mb=True)

    def normal(shape):
        if chain['mb']:
            chain['mb'] = False
            chain['vel'], sub = jax.random.split(chain['vel'])
            keys = jax.random.split(sub, R)
        else:
            keys = []
            for r in range(R):
                chain['reps'][r], k = jax.random.split(chain['reps'][r])
                keys.append(k)
        return torch.as_tensor(np.stack([np.asarray(jax.random.normal(k, shape[1:], jnp.float64))
                                         for k in keys]))

    def uniform(shape):
        chain['exch'], sub = jax.random.split(chain['exch'])
        return torch.as_tensor(np.asarray(jax.random.uniform(sub, shape, jnp.float64)))

    sim._normal, sim._uniform = normal, uniform


def _port_remd(pot, pos, seed=0, jax_draws=False):
    sim = remd.REMDSimulation(pot, LADDER, remd.REMDConfig(exchange_interval=5), seed=seed)
    if jax_draws:
        _feed_jax_draws(sim, seed)
    sim.set_positions(pos)
    sim.set_velocities_to_temperature()
    return sim


def test_remd_simulation_matches_jax(water14):
    pot, jpot, pos = water14
    jsim = JREMD.REMDSimulation(jpot, LADDER, JREMD.REMDConfig(exchange_interval=5), seed=0)
    jsim.set_positions(jnp.asarray(pos))
    jsim.set_velocities_to_temperature()
    jout = jsim.run(2)
    sim = _port_remd(pot, pos, jax_draws=True)
    assert sim._warm
    out = sim.run(2)
    assert np.max(np.abs(out['potential_energy'] - jout['potential_energy'])) <= 1e-8
    assert np.max(np.abs(sim.state.positions.numpy() - np.asarray(jsim.state.positions))) <= 1e-10
    np.testing.assert_array_equal(out['accept'], jout['accept'])
    np.testing.assert_array_equal(out['walker'], jout['walker'])
    np.testing.assert_array_equal(out['acceptance'], jout['acceptance'])


def test_remd_checkpoint_resume_bit_for_bit(water14, tmp_path):
    pot, _, pos = water14
    sim = _port_remd(pot, pos, seed=2)
    sim.run(1)
    sim.save_checkpoint(tmp_path / 'remd.npz')
    ref = sim.run(1)
    sim2 = remd.REMDSimulation(pot, LADDER, remd.REMDConfig(exchange_interval=5), seed=9)
    sim2.load_checkpoint_file(tmp_path / 'remd.npz')
    out = sim2.run(1)
    for k in ('potential_energy', 'accept', 'walker', 'acceptance'):
        np.testing.assert_array_equal(out[k], ref[k])
    for k in ('positions', 'velocities', 'forces'):
        np.testing.assert_array_equal(getattr(sim2.state, k).numpy(),
                                      getattr(sim.state, k).numpy())
    cold = remd.REMDSimulation(pot, LADDER, remd.REMDConfig(exchange_interval=5,
                                                            scf_warm_start=False))
    with pytest.raises(ValueError, match='warm-start'):
        cold.load_checkpoint(sim.checkpoint())
    with pytest.raises(ValueError, match='ladder'):
        remd.REMDSimulation(pot, [300.0, 400.0, 500.0, 600.0]).load_checkpoint(sim.checkpoint())


def test_remd_validates_ladder_and_one_replica(water14):
    pot, _, pos = water14
    with pytest.raises(ValueError):
        remd.REMDSimulation(pot, [])
    with pytest.raises(ValueError):
        remd.REMDSimulation(pot, [300.0, 300.0])
    with pytest.raises(TypeError, match='Mesh'):
        remd.REMDSimulation(pot, [300.0], mesh=object())
    with pytest.raises(ValueError, match='neighbor-list'):
        remd.REMDSimulation(pot, [300.0], remd.REMDConfig(nlist_reuse=True))
    frames = []
    sim = remd.REMDSimulation(pot, [300.0], remd.REMDConfig(exchange_interval=2))
    sim.set_positions(pos)
    sim.set_velocities_to_temperature()
    out = sim.run(2, frame_callback=lambda s, p, b: frames.append((s, p, b)))
    assert np.isfinite(out['potential_energy']).all() and out['acceptance'].shape == (0,)
    assert [f[0] for f in frames] == [2, 4] and frames[0][2] is None
    p0 = torch.as_tensor(frames[0][1])
    np.testing.assert_allclose(frames[0][1], compute_virtual_sites(sim.system, p0).numpy(),
                               atol=1e-12)
    assert not np.allclose(frames[0][1], frames[1][1])
