"""The port's ring-polymer MD (mbpol_openmm_plugin_tpu_torch/md/rpmd.py)
against the JAX package's, CPU float64, the JAX draws fed in.

- normal-mode, frequency and contraction matrices: 1e-14, and the odd-n_c
  refusal;
- contracted_energy_forces on water3 at 4 -> 1 and 4 -> 3 and on water50 PME
  (box 1.8 nm, cutoff 0.85 nm) at 2 -> 1: 1e-8 (energy kJ/mol, forces
  kJ/mol/nm);
- spring, centroid-virial and primitive estimators and
  ring_polymer_hamiltonian: 1e-10 relative;
- one make_rpmd_step on water3 (4 beads) and water50 PME (2 beads, also
  contracted to 1) fed the JAX key's normals: positions and velocities
  1e-10;
- rpmd_barostat_move, accepted and rejected, fed the JAX uniforms, on
  converged energy functions: box and positions 1e-12, energies 1e-8; an
  accepted move carries the forces of a fresh evaluation at its positions
  and box (1e-10), where the JAX function keeps the old ones (the gap is
  asserted and printed);
- PIMDSimulation against the JAX driver's chunk for 6 steps (water3, 2
  beads, ASPC and scf='keep'; water50 PME, contraction 2 -> 1, list interval
  2): per-step bead-mean energy and KE_cv within 1e-8 kJ/mol;
- a checkpoint resume bit for bit; the JAX guards (mesh, mesh with
  contraction, NPT on a cluster, the list-reuse guards, a box other than
  the system's); the step body with no host read (the guard of
  test_torch_step_capture.py); a dropped driver freed without the cyclic
  collector.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu.md import rpmd as JR
from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
from mbpol_openmm_plugin_tpu.system import System as JSystem
from mbpol_openmm_plugin_tpu.system import compute_virtual_sites as jvsites
from mbpol_openmm_plugin_tpu.system import make_molecules_whole as jwhole
from mbpol_openmm_plugin_tpu_torch.md import integrators as I
from mbpol_openmm_plugin_tpu_torch.md import rpmd as R
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.system import System
from test_torch_step_capture import PLAIN_TWINS, _Guard, _host_data_raising, _lifted, _raising

torch.set_num_threads(1)

T_K = 300.0
BOX50 = 1.8
W50 = dict(nonbonded_method='PME', cutoff=0.85, target_epsilon=1e-10, max_iterations=500,
           nlist_skin=0.05)
W3 = dict(nonbonded_method='NoCutoff', target_epsilon=1e-10, max_iterations=500)


@pytest.fixture(scope='module')
def water3():
    """(port potential, JAX potential, positions) of the water3 cluster."""
    jsys = JSystem.waters(3)
    pos = np.asarray(jvsites(jsys, jnp.asarray(fixtures.load('water3_cluster')['positions'])))
    return (MBPol(System.waters(3), MBPolConfig(**W3), device='cpu'),
            JMBPol(jsys, JConfig(**W3)), pos)


@pytest.fixture(scope='module')
def water50():
    """(port potential, JAX potential, whole positions) of water50 in a
    1.8 nm box, capacities tuned on both sides."""
    d = fixtures.load('water50')
    jsys = JSystem.from_atom_names(d['names'], d['resnames'], box=[BOX50] * 3)
    pos = np.asarray(jvsites(jsys, jwhole(jsys, jnp.asarray(d['positions']))))
    jpot = JMBPol(jsys, JConfig(**W50))
    jpot.tune_capacities(jnp.asarray(pos))
    pot = MBPol(System.from_atom_names(d['names'], d['resnames'], box=[BOX50] * 3),
                MBPolConfig(**W50), device='cpu')
    pot.tune_capacities(pos)
    return pot, jpot, pos


def _beads(pos, n, seed, scale=0.002):
    rng = np.random.default_rng(seed)
    real = (np.arange(pos.shape[0]) % 4 != 3)[None, :, None]
    return pos[None] + np.where(real, scale * rng.standard_normal((n,) + pos.shape), 0.0)


# ----------------------------------------------------------------------
# matrices, contraction, estimators
# ----------------------------------------------------------------------

@pytest.mark.parametrize('n', [1, 2, 3, 4, 8, 9, 16, 24])
def test_normal_mode_matrices(n):
    np.testing.assert_allclose(R.normal_mode_matrix(n), JR.normal_mode_matrix(n), atol=1e-14,
                               rtol=0)
    np.testing.assert_allclose(R.normal_mode_frequencies(n, T_K),
                               JR.normal_mode_frequencies(n, T_K), rtol=1e-14)
    for nc in range(1, n + 1):
        if nc == n or nc % 2:
            np.testing.assert_allclose(R.contraction_matrix(n, nc), JR.contraction_matrix(n, nc),
                                       atol=1e-14, rtol=0)
        else:
            for mod in (R, JR):
                with pytest.raises(ValueError, match='odd'):
                    mod.contraction_matrix(n, nc)
    assert R.HBAR_KJMOL_PS == JR.HBAR_KJMOL_PS


@pytest.mark.parametrize('case', ['water3_4to1', 'water3_4to3', 'water50_2to1'])
def test_contracted_energy_forces(request, case):
    name, nn = case.split('_')
    pot, jpot, pos = request.getfixturevalue(name)
    n, nc = int(nn[0]), int(nn[-1])
    q = _beads(pos, n, 1)
    ef_intra, pot_inter = R.mbpol_intra_inter_split(pot)
    ef = R.contracted_energy_forces(lambda p: pot_inter._energy_forces_impl(p)[:2], ef_intra,
                                    n, nc)
    e, f = ef(torch.as_tensor(q))
    j_intra, j_inter = JR.mbpol_intra_inter_split(jpot)
    e_j, f_j = jax.jit(JR.contracted_energy_forces(j_inter, j_intra, n, nc))(jnp.asarray(q))
    assert np.max(np.abs(e.numpy() - np.asarray(e_j))) <= 1e-8
    assert np.max(np.abs(f.numpy() - np.asarray(f_j))) <= 1e-8


def test_estimators_and_hamiltonian(water3):
    pot, jpot, pos = water3
    q = _beads(pos, 4, 2)
    rng = np.random.default_rng(3)
    f = rng.standard_normal(q.shape) * 100.0
    v = rng.standard_normal(q.shape)
    pe = rng.standard_normal(4) * 10.0
    sys_, jsys = pot.system, jpot.system
    qt, ft = torch.as_tensor(q), torch.as_tensor(f)
    pairs = [(R.spring_energy(sys_, qt, T_K), JR.spring_energy(jsys, jnp.asarray(q), T_K)),
             (R.kinetic_energy_virial(sys_, qt, ft, T_K),
              JR.kinetic_energy_virial(jsys, jnp.asarray(q), jnp.asarray(f), T_K)),
             (R.kinetic_energy_primitive(sys_, qt, T_K),
              JR.kinetic_energy_primitive(jsys, jnp.asarray(q), T_K))]
    st = I.MDState(positions=qt, velocities=torch.as_tensor(v), forces=ft,
                   potential_energy=torch.as_tensor(pe))
    jst = JR.initial_state(jsys, jnp.asarray(pos), 4, T_K, jax.random.PRNGKey(0))
    jst = dataclasses.replace(jst, positions=jnp.asarray(q), velocities=jnp.asarray(v),
                              potential_energy=jnp.asarray(pe))
    pairs.append((R.ring_polymer_hamiltonian(sys_, st, T_K),
                  JR.ring_polymer_hamiltonian(jsys, jst, T_K)))
    for ours, theirs in pairs:
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-10)


# ----------------------------------------------------------------------
# one step, one volume move
# ----------------------------------------------------------------------

@pytest.mark.parametrize('case', ['water3', 'water50', 'water50_contracted'])
def test_rpmd_step_matches_jax(request, case):
    """make_rpmd_potential_step, and make_rpmd_contracted_potential_step at
    2 -> 1 beads, against the JAX function fed the same normals."""
    name = case.split('_')[0]
    pot, jpot, pos = request.getfixturevalue(name)
    n = 4 if name == 'water3' else 2
    dt, tau0 = 2e-4, 0.05
    q = _beads(pos, n, 4)
    v = np.where((np.arange(pos.shape[0]) % 4 != 3)[None, :, None],
                 np.random.default_rng(5).standard_normal(q.shape), 0.0)
    if case.endswith('contracted'):
        jstep = JR.make_rpmd_contracted_potential_step(jpot, n, 1, dt, T_K, tau0=tau0)
        step = R.make_rpmd_contracted_potential_step(pot, n, 1, dt, T_K, tau0=tau0)
    else:
        jstep = JR.make_rpmd_potential_step(jpot, n, dt, T_K, tau0=tau0)
        step = R.make_rpmd_potential_step(pot, n, dt, T_K, tau0=tau0)
    # the start's forces and energies from the port on both sides
    out = [pot._energy_forces_impl(p)[:2] for p in torch.as_tensor(q)]
    e0 = np.array([float(o[0]) for o in out])
    f0 = np.stack([o[1].numpy() for o in out])
    jst = JR.initial_state(jpot.system, jnp.asarray(pos), n, T_K, jax.random.PRNGKey(6))
    jst = dataclasses.replace(jst, positions=jnp.asarray(q), velocities=jnp.asarray(v),
                              forces=jnp.asarray(f0), potential_energy=jnp.asarray(e0))
    noise = jax.random.normal(jax.random.split(jst.rng)[1], q.shape, jnp.float64)
    jnew = jax.jit(jstep)(jst)

    st = I.MDState(positions=torch.as_tensor(q), velocities=torch.as_tensor(v),
                   forces=torch.as_tensor(f0), potential_energy=torch.as_tensor(e0),
                   box=pot.system.box)
    new = step(st, torch.as_tensor(np.asarray(noise)))
    assert np.max(np.abs(new.positions.numpy() - np.asarray(jnew.positions))) <= 1e-10
    assert np.max(np.abs(new.velocities.numpy() - np.asarray(jnew.velocities))) <= 1e-10
    assert np.max(np.abs(new.potential_energy.numpy() - np.asarray(jnew.potential_energy))) \
        <= 1e-8


@pytest.mark.parametrize('want', [True, False])
def test_rpmd_barostat_move_matches_jax(want):
    """Water3 in a 2 nm PME box, 4 beads, 1e4 bar (so that some moves are
    rejected); the first JAX key whose move is accepted (rejected)."""
    box = [2.0] * 3
    cfg = dict(nonbonded_method='PME', cutoff=0.9, target_epsilon=1e-10, max_iterations=500)
    jsys = JSystem.waters(3, box=box)
    pos = np.asarray(jvsites(jsys, jnp.asarray(fixtures.load('water3_cluster')['positions'])))
    pos = pos + 1.0
    jpot = JMBPol(jsys, JConfig(**cfg))
    pot = MBPol(System.waters(3, box=box), MBPolConfig(**cfg), device='cpu')
    jef = jax.jit(jax.vmap(lambda p, b: jpot._energy_forces_impl(p, box=b)[:2],
                           in_axes=(0, None)))

    def ef(q, b):
        out = [pot._energy_forces_impl(p, box=b)[:2] for p in q]
        return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])

    q = _beads(pos, 4, 7)
    e0, f0 = jef(jnp.asarray(q), jnp.asarray(box))
    for seed in range(40):
        jst = JR.initial_state(jsys, jnp.asarray(pos), 4, T_K, jax.random.PRNGKey(seed))
        jst = dataclasses.replace(jst, positions=jnp.asarray(q), forces=f0, potential_energy=e0)
        jnew, acc = JR.rpmd_barostat_move(jsys, lambda x, b: jef(x, b)[0], jst, T_K, 1e4)
        if bool(acc) == want:
            break
    assert bool(acc) == want
    _, k1, k2 = jax.random.split(jst.rng, 3)
    uniforms = torch.as_tensor([float(jax.random.uniform(k1)), float(jax.random.uniform(k2))],
                               dtype=torch.float64)
    st = I.MDState(positions=torch.as_tensor(q), velocities=torch.zeros(q.shape),
                   forces=torch.as_tensor(np.asarray(f0)),
                   potential_energy=torch.as_tensor(np.asarray(e0)), box=np.asarray(box))
    new, accepted = R.rpmd_barostat_move(pot.system, ef, st, T_K, 1e4, uniforms)
    assert accepted == want
    np.testing.assert_allclose(new.box, np.asarray(jnew.box), rtol=0, atol=1e-12)
    assert np.max(np.abs(new.positions.numpy() - np.asarray(jnew.positions))) <= 1e-12
    assert np.max(np.abs(new.potential_energy.numpy() - np.asarray(jnew.potential_energy))) \
        <= 1e-8
    if want:
        _, f_fresh = ef(new.positions, new.box)
        assert np.max(np.abs(new.forces.numpy() - f_fresh.numpy())) <= 1e-10
        # the reference keeps the forces of the old positions and box
        gap = float(np.max(np.abs(np.asarray(jnew.forces) - f_fresh.numpy())))
        print(f'JAX rpmd_barostat_move stale-force gap: {gap:.4f} kJ/mol/nm')
        assert gap > 1e-3
    else:
        np.testing.assert_array_equal(new.forces.numpy(), np.asarray(f0))


# ----------------------------------------------------------------------
# PIMDSimulation against the JAX driver, fed the JAX draws
# ----------------------------------------------------------------------

def _feed_jax_draws(sim, seed):
    """Make sim draw what the JAX PIMDSimulation draws: the spread's
    normals from split(PRNGKey(seed))[1], each step's O normals from a
    split of the state key, the volume move's two uniforms from split(key,
    3)."""
    key, k_spread = jax.random.split(jax.random.PRNGKey(seed))
    chain = [key, k_spread]

    def normal(shape):
        if chain[1] is not None:
            k, chain[1] = chain[1], None
        else:
            chain[0], k = jax.random.split(chain[0])
        return torch.as_tensor(np.array(jax.random.normal(k, shape, jnp.float64)))

    def uniform(shape):
        chain[0], k1, k2 = jax.random.split(chain[0], 3)
        return torch.as_tensor([float(jax.random.uniform(k1)), float(jax.random.uniform(k2))],
                               dtype=torch.float64)

    sim._normal, sim._uniform = normal, uniform


SIM_CASES = {
    'water3_aspc': ('water3', dict(n_beads=2, dt=2e-4, tau0=0.05, seed=5)),
    'water3_keep': ('water3', dict(n_beads=2, dt=2e-4, tau0=0.05, seed=5, scf='keep')),
    'water50_contracted_nl2': ('water50', dict(n_beads=2, dt=2e-4, tau0=0.05, seed=6,
                                               contraction=1, nlist_rebuild_interval=2)),
}


@pytest.mark.parametrize('case', list(SIM_CASES))
def test_pimd_simulation_matches_jax(request, case):
    name, kw = SIM_CASES[case]
    pot, jpot, pos = request.getfixturevalue(name)
    n_steps = 6
    jsim = JR.PIMDSimulation(jpot, temperature=T_K, **kw)
    jsim.set_positions(jnp.asarray(pos), spread=0.002)
    mu_arg = jsim._mu
    if jsim._nl_reuse:
        nl, ov = jax.jit(lambda x: jsim._nl_builder(jsim._to_eval(x)))(jsim.state.positions)
        mu_arg = (jsim._mu, nl, ov)
    jstate, _, _, (pes, kes) = jsim._chunk(jsim.state, mu_arg, jsim._baro_state, n=n_steps)

    sim = R.PIMDSimulation(pot, temperature=T_K, **kw)
    assert not sim.captured and (sim._aspc, sim._warm) == (jsim._aspc, jsim._warm)
    _feed_jax_draws(sim, kw['seed'])
    sim.set_positions(pos, spread=0.002)
    out = sim.step(n_steps, check_health=False)
    pe_j = np.asarray(pes) / kw['n_beads']
    assert np.max(np.abs(out['step_potential_energy'] - pe_j)) <= 1e-8
    assert np.max(np.abs(out['step_kinetic_virial'] - np.asarray(kes))) <= 1e-8
    assert np.max(np.abs(sim.state.positions.numpy() - np.asarray(jstate.positions))) <= 1e-10


def test_pimd_checkpoint_resume_bit_for_bit(water50):
    """Contraction, list interval 2 and the ASPC history: 4 + checkpoint
    file + a new driver + 4 steps equal 8 steps."""
    pot, _, pos = water50
    kw = dict(n_beads=2, dt=2e-4, temperature=T_K, tau0=0.05, seed=3, contraction=1,
              nlist_rebuild_interval=2)
    ref = R.PIMDSimulation(pot, **kw)
    ref.set_positions(pos, spread=0.002)
    a = ref.step(8, report_interval=4, check_health=False)
    sim = R.PIMDSimulation(pot, **kw)
    sim.set_positions(pos, spread=0.002)
    b1 = sim.step(4, check_health=False)
    ck = sim.checkpoint()
    assert ck['mu'].shape == (1, sim._hist_len, pot.system.n_atoms, 3) and np.any(ck['mu'])
    sim2 = R.PIMDSimulation(pot, **dict(kw, seed=99))
    sim2.load_checkpoint(ck)
    b2 = sim2.step(4, check_health=False)
    np.testing.assert_array_equal(np.concatenate([b1['step_hamiltonian'],
                                                  b2['step_hamiltonian']]),
                                  a['step_hamiltonian'])
    for k in ('positions', 'velocities', 'forces', 'potential_energy'):
        np.testing.assert_array_equal(getattr(sim2.state, k).numpy(),
                                      getattr(ref.state, k).numpy())


def test_pimd_guards(water3):
    pot, _, pos = water3
    with pytest.raises(ValueError, match='mesh \\+ contraction'):
        R.PIMDSimulation(pot, n_beads=8, contraction=1, mesh=object())
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        R.PIMDSimulation(pot, n_beads=8, mesh=object())
    with pytest.raises(ValueError, match='periodic'):
        R.PIMDSimulation(pot, n_beads=2, barostat_pressure=1.0)
    with pytest.raises(ValueError, match='neighbor-list'):
        R.PIMDSimulation(pot, n_beads=2, nlist_rebuild_interval=4)
    sysb = System.waters(50, box=[BOX50] * 3)
    p0 = MBPol(sysb, MBPolConfig(nonbonded_method='PME', cutoff=0.45, nlist_skin=0.0),
               device='cpu')
    with pytest.raises(ValueError, match='nlist_skin'):
        R.PIMDSimulation(p0, n_beads=2, nlist_rebuild_interval=4)
    ps = MBPol(sysb, MBPolConfig(nonbonded_method='PME', cutoff=0.45, nlist_skin=0.05),
               device='cpu')
    with pytest.raises(ValueError, match='NPT'):
        R.PIMDSimulation(ps, n_beads=2, nlist_rebuild_interval=4, barostat_pressure=1.0)
    with pytest.raises(ValueError, match='scf'):
        R.PIMDSimulation(pot, n_beads=2, scf='cold')
    p = torch.as_tensor(pos)
    with pytest.raises(ValueError, match='non-periodic'):
        R.initial_state(pot.system, p, 2, T_K, box=[2.0] * 3)
    sysp = System.waters(3, box=[1.8] * 3)
    with pytest.raises(ValueError, match='system.box'):
        R.initial_state(sysp, p, 2, T_K, box=[2.0] * 3)
    R.initial_state(sysp, p, 2, T_K, box=[1.8] * 3)
    sim = R.PIMDSimulation(pot, n_beads=2, contraction=1)
    sim.set_positions(pos)
    with pytest.raises(ValueError, match='periodic'):
        sim.step(1, report_pressure=True)


def test_pimd_frame_callback_gets_the_centroid(water3):
    """frame_callback at each report boundary: the bead centroid with the
    M sites placed, the step count, no box for a cluster."""
    pot, _, pos = water3
    frames = []
    sim = R.PIMDSimulation(pot, n_beads=2, dt=2e-4, temperature=T_K, contraction=1, seed=1)
    sim.set_positions(pos, spread=0.002)
    sim.step(2, report_interval=1, check_health=False,
             frame_callback=lambda st, p, b: frames.append((st, p, b)))
    assert [f[0] for f in frames] == [1, 2] and frames[1][2] is None
    centroid = torch.mean(sim.state.positions, dim=0)
    expect = R.compute_virtual_sites(pot.system, centroid).numpy()
    np.testing.assert_allclose(frames[1][1], expect, atol=1e-14)
    assert not np.allclose(frames[1][1][3], centroid.numpy()[3])   # the M site placed


# ----------------------------------------------------------------------
# the step body reads nothing on the host
# ----------------------------------------------------------------------

@pytest.fixture
def pimd_guard(monkeypatch):
    for name in ('__bool__', '__float__', '__int__', 'item', 'tolist', 'cpu', 'numpy'):
        monkeypatch.setattr(torch.Tensor, name, _raising(name, getattr(torch.Tensor, name)))
    for name in ('as_tensor', 'tensor', 'from_numpy'):
        monkeypatch.setattr(torch, name, _host_data_raising(name, getattr(torch, name)))
    for mod, names in PLAIN_TWINS:
        for name in names:
            monkeypatch.setattr(mod, name, _lifted(getattr(mod, name)))
    calls = []
    body = R.PIMDSimulation._body

    def guarded(self, g):
        calls.append(g)
        _Guard.on = len(calls) > 1
        try:
            return body(self, g)
        finally:
            _Guard.on = False
    monkeypatch.setattr(R.PIMDSimulation, '_body', guarded)
    yield calls
    _Guard.on = False


@pytest.mark.parametrize('case', ['full_nl2', 'contracted_nl2'])
def test_pimd_body_reads_nothing_on_the_host(water50, pimd_guard, case):
    pot, _, pos = water50
    pot = MBPol(pot.system, MBPolConfig.for_dynamics(cutoff=0.85), device='cpu')
    kw = (dict(n_beads=2, nlist_rebuild_interval=2) if case == 'full_nl2'
          else dict(n_beads=3, contraction=1, nlist_rebuild_interval=2))
    sim = R.PIMDSimulation(pot, temperature=T_K, **kw)
    sim.set_positions(pos, spread=0.002)
    out = sim.step(3, check_health=False)
    assert len(pimd_guard) == 3 and np.all(np.isfinite(out['step_hamiltonian']))


def _driver(kind, pot, pos):
    """A driver of `kind` that has run two steps (or one REMD block)."""
    from mbpol_openmm_plugin_tpu_torch.md import remd
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
    if kind == 'remd':
        sim = remd.REMDSimulation(pot, [300.0, 330.0], remd.REMDConfig(exchange_interval=2))
        sim.set_positions(pos)
        sim.run(1)
    elif kind == 'md':
        sim = Simulation(pot, SimulationConfig(thermostat='langevin'))
        sim.set_positions(pos)
        sim.step(2)
    else:
        sim = R.PIMDSimulation(pot, 4, contraction=1 if kind == 'pimd_contracted' else None)
        sim.set_positions(pos, spread=0.001)
        sim.step(2, check_health=False)
    return sim


@pytest.mark.parametrize('kind', ['pimd', 'pimd_contracted', 'remd', 'md'])
def test_dropped_driver_is_freed_without_the_collector(water3, kind):
    """A driver holds no reference cycle (its step function is built from
    the potential, not from the driver), so dropping it frees it, and on a
    card its CUDA graph, at once: the cyclic collector can never destroy
    a graph in the middle of another driver's capture."""
    import gc
    import weakref
    pot, _, pos = water3
    _driver(kind, pot, pos)     # first evaluations (one-time caches)
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        ref = weakref.ref(_driver(kind, pot, pos))
        assert ref() is None
    finally:
        if was_enabled:
            gc.enable()
