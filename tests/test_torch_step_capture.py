"""The MD step body that the port captures as a CUDA graph
(Simulation._body on the buffers of md/step_graph.StepGraph), on the CPU,
float64, water50 PME (box 1.8 nm, cutoff 0.85 nm).

(a) The body against the JAX Simulation's compiled chunk (_step_chunk)
    under for_dynamics with a 0.002 nm skin, so that the displacement
    trigger fires inside the chunk (the port's count is asserted): velocity
    Verlet, Langevin with CM removal every step, and Andersen with CM
    removal every second step, fed the draws of the JAX key splits; per-step
    potential energy, final total energy and positions within 1e-8 kJ/mol
    and 1e-10 nm.
(b) A guard: after one step has filled the constant caches, every later
    call of the body runs with Tensor.__bool__/__float__/__int__/item/
    tolist/cpu/numpy raising, and torch.as_tensor/torch.tensor/
    torch.from_numpy raising on host data; the guard is lifted only inside
    the kernel wrappers' plain twins, which a card never runs. Dense, block
    (electrostatics_mode='block', one 256-site tile), pip_impl='quad_bf16',
    and the water14 cluster under its restraint.
(c) The launch counts of a captured group (md/step_graph.LaunchLedger) as
    plain Python: the warm-up step counts once, the capture counts nothing,
    each replay counts what the capture recorded.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu.md.simulation import Simulation as JSimulation
from mbpol_openmm_plugin_tpu.md.simulation import SimulationConfig as JSimConfig
from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
from mbpol_openmm_plugin_tpu.system import make_molecules_whole
from mbpol_openmm_plugin_tpu_torch.md import step_graph
from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as BS
from mbpol_openmm_plugin_tpu_torch.ops import pip_fused as PF
from mbpol_openmm_plugin_tpu_torch.system import System

torch.set_num_threads(1)

BOX = 1.8
CUTOFF = 0.85
SKIN = 0.002
T_K = 300.0
DT = 0.0002
N_STEPS = 6
KB = 0.00831446261815324


@pytest.fixture(scope='module')
def water50():
    """(port System, JAX System, whole positions, velocities at 300 K)."""
    from mbpol_openmm_plugin_tpu.md import integrators as JI
    jsys, pos = fixtures.load_system('water50', box=[BOX] * 3)
    pos = np.array(make_molecules_whole(jsys, pos))
    d = fixtures.load('water50')
    tsys = System.from_atom_names(d['names'], d['resnames'], box=[BOX] * 3)
    vel = np.array(JI.maxwell_boltzmann_velocities(jsys, T_K, jax.random.PRNGKey(7)))
    return tsys, jsys, pos, vel


def _feed_jax_draws(sim, key, n_atoms):
    """Make sim draw what the JAX integrators draw from the key chain
    (langevin_step: split(key) -> normals; andersen_thermostat:
    split(key, 3) -> uniforms, normals)."""
    chain = [key, None]

    def normal(shape):
        if chain[1] is not None:            # Andersen's normals after its uniforms
            k, chain[1] = chain[1], None
        else:
            chain[0], k = jax.random.split(chain[0])
        return torch.as_tensor(np.array(jax.random.normal(k, shape, jnp.float64)))

    def uniform(shape):
        chain[0], k1, chain[1] = jax.random.split(chain[0], 3)
        assert tuple(shape) == (n_atoms,)
        return torch.as_tensor(np.array(jax.random.uniform(k1, shape)))

    sim._normal, sim._uniform = normal, uniform


CASES = {
    'verlet': dict(),
    'langevin_cm1': dict(temperature=T_K, thermostat='langevin', friction=50.0,
                         cm_motion_interval=1),
    'andersen_cm2': dict(temperature=T_K, thermostat='andersen', collision_frequency=1000.0,
                         cm_motion_interval=2),
}


@pytest.mark.parametrize('case', list(CASES))
def test_body_matches_jax_step_chunk(water50, case):
    tsys, jsys, pos, vel = water50
    seed = 5
    scfg = dict(dt=DT, nlist_rebuild_interval='auto', **CASES[case])
    kw = dict(cutoff=CUTOFF, nlist_skin=SKIN)
    jsim = JSimulation(JMBPol(jsys, JConfig.for_dynamics(**kw)), JSimConfig(**scfg), seed=seed)
    jsim.set_positions(jnp.asarray(pos))
    jsim.state = dataclasses.replace(jsim.state, velocities=jnp.asarray(vel))
    jstate, _, pe_j, ke_j, _ = jsim._step_chunk(jsim.state, None, n_steps=N_STEPS)

    sim = Simulation(MBPol(tsys, MBPolConfig.for_dynamics(**kw), device='cpu'),
                     SimulationConfig(**scfg), seed=seed)
    assert not sim.captured            # the CPU runs the body eagerly
    sim.set_positions(pos)
    sim.state = dataclasses.replace(sim.state, velocities=torch.as_tensor(vel))
    _feed_jax_draws(sim, jax.random.PRNGKey(seed), tsys.n_atoms)
    calls = []
    body = Simulation._body

    def counted(self, g):
        calls.append(g)
        return body(self, g)
    sim._body = counted.__get__(sim)
    out = sim.step(N_STEPS)
    assert len(calls) == N_STEPS
    # the trigger fired on some steps and not on others: both sides of the select
    assert 1 <= sim.list_rebuilds < N_STEPS, sim.list_rebuilds
    ke = out['step_temperature'] * 3 * 3 * tsys.n_waters * 0.5 * KB
    pe = out['step_total_energy'][1:] - ke
    assert np.max(np.abs(pe - np.asarray(pe_j))) <= 1e-8
    assert abs(out['total_energy'][-1] - (float(pe_j[-1]) + float(ke_j))) <= 1e-8
    assert np.max(np.abs(sim.state.positions.numpy() - np.asarray(jstate.positions))) <= 1e-10


# ----------------------------------------------------------------------
# (b) no host read and no host copy inside the body
# ----------------------------------------------------------------------

class _Guard:
    on = False


def _raising(name, orig):
    def f(self, *a, **k):
        if _Guard.on:
            raise RuntimeError(f'host read inside the MD step body: Tensor.{name}')
        return orig(self, *a, **k)
    return f


def _host_data_raising(name, orig):
    def f(data, *a, **k):
        if _Guard.on and not isinstance(data, torch.Tensor):
            raise RuntimeError(f'host-to-device copy inside the MD step body: torch.{name}')
        return orig(data, *a, **k)
    return f


def _lifted(orig):
    def f(*a, **k):
        was, _Guard.on = _Guard.on, False
        try:
            return orig(*a, **k)
        finally:
            _Guard.on = was
    return f


PLAIN_TWINS = ((ED, ('fixed_field_and_scf_factors_plain', 'direct_energy_force_pot_plain')),
               (BS, ('fixed_field_and_scf_lines_plain', 'scf_dipole_field_bs_plain',
                     'direct_energy_force_pot_bs_plain')),
               (PF, ('pip_energy_grad_plain', 'pip_quad_energy_grad_plain',
                     'pip_quad_product_energy_grad_plain', 'pip_vech_energy_grad_plain')))


@pytest.fixture
def guard(monkeypatch):
    for name in ('__bool__', '__float__', '__int__', 'item', 'tolist', 'cpu', 'numpy'):
        monkeypatch.setattr(torch.Tensor, name, _raising(name, getattr(torch.Tensor, name)))
    for name in ('as_tensor', 'tensor', 'from_numpy'):
        monkeypatch.setattr(torch, name, _host_data_raising(name, getattr(torch, name)))
    for mod, names in PLAIN_TWINS:
        for name in names:
            monkeypatch.setattr(mod, name, _lifted(getattr(mod, name)))
    calls = []
    body = Simulation._body

    def guarded(self, g):
        # the first call is the warm-up step, which fills the caches
        calls.append(g)
        _Guard.on = len(calls) > 1
        try:
            return body(self, g)
        finally:
            _Guard.on = False
    monkeypatch.setattr(Simulation, '_body', guarded)
    yield calls
    _Guard.on = False


def test_guard_catches_reads_and_copies(guard):
    t = torch.ones(3)
    _Guard.on = True
    try:
        for fn in (lambda: float(t[0]), lambda: bool(t[0]), lambda: t.tolist(),
                   lambda: torch.as_tensor(np.ones(2)), lambda: torch.tensor(1.0)):
            with pytest.raises(RuntimeError, match='MD step body'):
                fn()
        torch.as_tensor(t)                 # a tensor is no host data
    finally:
        _Guard.on = False


GUARD_CASES = {
    'dense_langevin': (dict(), dict(temperature=T_K, thermostat='langevin', friction=10.0)),
    'block_andersen': (dict(electrostatics_mode='block', dispersion_mode='pairs'),
                       dict(temperature=T_K, thermostat='andersen',
                            collision_frequency=1000.0)),
    'quad_bf16': (dict(pip_impl='quad_bf16'), dict()),
}


@pytest.mark.parametrize('case', list(GUARD_CASES))
def test_body_reads_nothing_on_the_host(water50, guard, case):
    tsys, _, pos, vel = water50
    mcfg, scfg = GUARD_CASES[case]
    pot = MBPol(tsys, MBPolConfig.for_dynamics(cutoff=CUTOFF, **mcfg), device='cpu')
    sim = Simulation(pot, SimulationConfig(dt=DT, nlist_rebuild_interval='auto', **scfg))
    sim.set_positions(pos)
    sim.state = dataclasses.replace(sim.state, velocities=torch.as_tensor(vel))
    out = sim.step(3)
    assert len(guard) == 3 and np.all(np.isfinite(out['step_total_energy']))
    if case == 'block_andersen':
        assert pot.elec_mode == 'block'


def test_cluster_body_reads_nothing_on_the_host(guard):
    d = fixtures.load('water14_cluster')
    tsys = System.from_atom_names(d['names'], d['resnames'])
    pot = MBPol(tsys, MBPolConfig(nonbonded_method='NoCutoff', target_epsilon=1e-3,
                                  restraint_radius=0.75, restraint_k=1000.0), device='cpu')
    sim = Simulation(pot, SimulationConfig(dt=DT, temperature=T_K, thermostat='langevin',
                                           friction=1.0), seed=1)
    assert sim.potential.config.scf_method == 'aspc'
    sim.set_positions(np.array(d['positions']))
    sim.set_velocities_to_temperature(T_K)
    out = sim.step(3)
    assert len(guard) == 3 and np.all(np.isfinite(out['step_total_energy']))


# ----------------------------------------------------------------------
# (c) launch counts across a captured group
# ----------------------------------------------------------------------

class _Wrapper:
    def __init__(self, per_call):
        self.launches = 0
        self.per_call = per_call

    def __call__(self):
        self.launches += self.per_call


@pytest.mark.parametrize('n_steps', [1, 2, 7])
def test_launch_ledger_counts_replays(n_steps):
    k1, k3, k2 = _Wrapper(1), _Wrapper(2), _Wrapper(1)
    ledger = step_graph.LaunchLedger((k1, k3, k2))

    def body():
        k1(), k3(), k2()
    body()                        # the warm-up step: the wrappers launch
    ledger.begin_capture()
    body()                        # recorded: nothing runs, nothing counts
    ledger.end_capture()
    assert ledger.per_replay == [1, 2, 1]
    assert (k1.launches, k3.launches, k2.launches) == (1, 2, 1)
    for _ in range(n_steps - 1):
        ledger.replayed()
    assert (k1.launches, k3.launches, k2.launches) == (n_steps, 2 * n_steps, n_steps)
    # a second box: a new ledger, its warm-up and capture, one replay
    again = step_graph.LaunchLedger((k1, k3, k2))
    body()
    again.begin_capture()
    body()
    again.end_capture()
    again.replayed()
    assert k3.launches == 2 * (n_steps + 2)


def test_kernel_wrappers_are_every_kernel_route():
    names = {w.__name__ for w in step_graph.kernel_wrappers()}
    assert names == {'fixed_field_and_scf_factors', 'direct_energy_force_pot',
                     'fixed_field_and_scf_lines', 'scf_dipole_field_bs',
                     'direct_energy_force_pot_bs', 'pip_energy_grad', 'pip_quad_energy_grad',
                     'pip_quad_product_energy_grad', 'pip_vech_energy_grad'}
