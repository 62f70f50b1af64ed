"""The port's device mesh in the MD layer and on larger inputs, CPU float64,
the port's shards on 'cpu' (parallel/mesh.make_mesh(devices=['cpu'] * k)).

- the cluster path (water14, NoCutoff): the port's cluster_electrostatics
  under an 8-shard mesh against JAX's cluster_electrostatics(mesh=) on its 8
  virtual host devices (energy rtol 1e-9, forces atol 1e-8, dipoles 1e-10),
  and MBPol(mesh=) against the unmeshed potential;
- the port meshed against the port unmeshed on water50 (box 1.8 nm, cutoff
  0.85 nm), dense, block and sparse, 4 shards: energy rtol 1e-9, forces
  atol 1e-8;
- a 10-step Simulation on water50 meshed over 2 shards against the
  unmeshed one, within 1e-9 nm, and the r-RESPA rungs carrying the
  potential's mesh;
- the per-shard clone of a potential (MBPol.to_device) equal to
  the original bit for bit (block mode: its own tables and block layout);
- PIMD (water3, 8 beads, 4 shards) and REMD (water3, R = 4, 2 shards)
  equal to the unmeshed runs bit for bit, each shard's beads or slots
  through its own clone of the potential;
- the meshed MD step body under the host-read guard of
  tests/test_torch_step_capture.py (the row kernels' plain twins lifted
  with the other kernels' twins).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu.models import electrostatics as jelec
from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
from mbpol_openmm_plugin_tpu.parallel import mesh as JM
from mbpol_openmm_plugin_tpu.system import System as JSystem
from mbpol_openmm_plugin_tpu.system import compute_virtual_sites as jvsites
from mbpol_openmm_plugin_tpu.system import make_molecules_whole as jwhole
from mbpol_openmm_plugin_tpu_torch.md import remd
from mbpol_openmm_plugin_tpu_torch.md import rpmd as R
from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
from mbpol_openmm_plugin_tpu_torch.models import electrostatics as elec
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
from mbpol_openmm_plugin_tpu_torch.parallel import mesh as M
from mbpol_openmm_plugin_tpu_torch.system import System
from test_torch_step_capture import _Guard, _lifted, guard  # noqa: F401  (the guard fixture)

torch.set_num_threads(1)

E_RTOL, F_ATOL = 1e-9, 1e-8
BOX50 = 1.8
W50 = dict(nonbonded_method='PME', cutoff=0.85, target_epsilon=1e-9, max_iterations=500)
W3 = dict(nonbonded_method='NoCutoff', target_epsilon=1e-10, max_iterations=500)


def _cpu_mesh(k):
    return M.make_mesh(devices=['cpu'] * k)


@pytest.fixture(scope='module')
def water50():
    """(port system, whole positions with the M sites placed)."""
    d = fixtures.load('water50')
    jsys = JSystem.from_atom_names(d['names'], d['resnames'], box=[BOX50] * 3)
    pos = np.asarray(jvsites(jsys, jwhole(jsys, jnp.asarray(d['positions']))))
    return System.from_atom_names(d['names'], d['resnames'], box=[BOX50] * 3), pos


@pytest.fixture(scope='module')
def water3():
    tsys = System.waters(3)
    jsys = JSystem.waters(3)
    pos = np.asarray(jvsites(jsys, jnp.asarray(fixtures.load('water3_cluster')['positions'])))
    return MBPol(tsys, MBPolConfig(**W3), device='cpu'), pos


def test_cluster_mesh_vs_jax_mesh():
    d = fixtures.load('water14_cluster')
    jsys = JSystem.from_atom_names(d['names'], d['resnames'])
    pos = np.array(jvsites(jsys, jnp.asarray(d['positions'])))
    jpot = JMBPol(jsys, JConfig(**W3))
    jmesh = JM.make_mesh(8)
    params = jpot.elec_params
    with jmesh:
        e_j, f_j, d_j = jax.jit(lambda p: jelec.cluster_electrostatics(params, p, mesh=jmesh))(
            jnp.asarray(pos))
    mesh = _cpu_mesh(8)
    tsys = System.from_atom_names(d['names'], d['resnames'])
    tpot = MBPol(tsys, MBPolConfig(**W3), mesh=mesh)
    e, f, dg = elec.cluster_electrostatics(tpot.elec_params, torch.as_tensor(pos), mesh=mesh)
    np.testing.assert_allclose(float(e), float(e_j), rtol=E_RTOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), atol=F_ATOL)
    np.testing.assert_allclose(dg['induced_dipoles'].numpy(), np.asarray(d_j['induced_dipoles']),
                               atol=1e-10)
    e1, f1, _, _ = tpot.energy_forces(pos)
    e2, f2, _, _ = MBPol(tsys, MBPolConfig(**W3), device='cpu').energy_forces(pos)
    np.testing.assert_allclose(float(e1), float(e2), rtol=E_RTOL)
    np.testing.assert_allclose(f1.numpy(), f2.numpy(), atol=F_ATOL)


@pytest.mark.parametrize('mode', ['dense', 'block', 'sparse'])
def test_port_meshed_equals_unmeshed_water50(water50, mode):
    tsys, pos = water50
    cfg = MBPolConfig(electrostatics_mode=mode, nlist_skin=0.02, **W50)
    ref = MBPol(tsys, cfg, device='cpu').tune_capacities(pos)
    pot = MBPol(tsys, cfg, mesh=_cpu_mesh(4)).tune_capacities(pos)
    e0, f0, parts0, d0 = ref.energy_forces(pos)
    e, f, parts, d = pot.energy_forces(pos)
    assert bool(d['converged']) and not any(bool(v) for k, v in d.items()
                                            if k.endswith('_overflow'))
    np.testing.assert_allclose(float(e), float(e0), rtol=E_RTOL)
    np.testing.assert_allclose(f.numpy(), f0.numpy(), atol=F_ATOL)
    for k in parts0:
        np.testing.assert_allclose(float(parts[k]), float(parts0[k]), rtol=E_RTOL, atol=1e-10)
    np.testing.assert_allclose(d['induced_dipoles'].numpy(), d0['induced_dipoles'].numpy(),
                               atol=1e-10)


def _md(tsys, pos, mesh, steps):
    pot = MBPol(tsys, MBPolConfig.for_dynamics(cutoff=0.85), device='cpu', mesh=mesh)
    sim = Simulation(pot, SimulationConfig(dt=0.0002, nlist_rebuild_interval='auto'), seed=4)
    sim.set_positions(pos)
    sim.set_velocities_to_temperature(300.0)
    out = sim.step(steps)
    return sim, out


def test_meshed_simulation_equals_unmeshed(water50):
    tsys, pos = water50
    ref, out0 = _md(tsys, pos, None, 10)
    sim, out = _md(tsys, pos, _cpu_mesh(2), 10)
    assert sim.potential.mesh.size == 2 and not sim.captured
    assert np.max(np.abs(sim.state.positions.numpy() - ref.state.positions.numpy())) <= 1e-9
    np.testing.assert_allclose(out['step_total_energy'], out0['step_total_energy'], rtol=1e-9)
    rsim = Simulation(sim.potential, SimulationConfig(dt=0.0002, respa_inner=2))
    assert all(rung.mesh is sim.potential.mesh for rung in
               (rsim._respa_rungs()['inter'], rsim._respa_rungs()['slow']))


def test_potential_copy_equals_original(water50):
    """The clone that each shard's beads and replicas run through
    (MBPol.to_device): its own tables and block layout, the
    original's bits."""
    tsys, pos = water50
    cfg = MBPolConfig(electrostatics_mode='block', nlist_skin=0.02, **W50)
    pot = MBPol(tsys, cfg, device='cpu').tune_capacities(pos)
    e0, f0, _, _ = pot.energy_forces(pos)
    cp = pot.to_device('cpu')
    assert cp is not pot and cp._tables is None and cp._block_info is not pot._block_info
    assert cp._block_info['tile_pair_capacity'] == pot._block_info['tile_pair_capacity']
    e, f, _, _ = cp.energy_forces(pos)
    assert cp._tables is not pot._tables
    assert torch.equal(e, e0) and torch.equal(f, f0)


def test_pimd_mesh_is_bitwise_unmeshed(water3):
    pot, pos = water3
    runs = []
    for mesh in (None, _cpu_mesh(4)):
        sim = R.PIMDSimulation(pot, n_beads=8, dt=2e-4, seed=3, mesh=mesh)
        sim.set_positions(pos, spread=0.002)
        out = sim.step(4, check_health=False)
        runs.append((out, sim.state))
    (a, sa), (b, sb) = runs
    for k in ('step_hamiltonian', 'step_potential_energy', 'step_kinetic_virial'):
        np.testing.assert_array_equal(a[k], b[k])
    for k in ('positions', 'velocities', 'forces'):
        assert torch.equal(getattr(sa, k), getattr(sb, k)), k


def test_remd_mesh_is_bitwise_unmeshed(water3):
    pot, pos = water3
    runs = []
    for mesh in (None, _cpu_mesh(2)):
        sim = remd.REMDSimulation(pot, [300.0, 330.0, 365.0, 400.0],
                                  remd.REMDConfig(exchange_interval=2), seed=1, mesh=mesh)
        sim.set_positions(pos)
        sim.set_velocities_to_temperature()
        out = sim.run(3, check_health=False)
        runs.append((out, sim.state))
    (a, sa), (b, sb) = runs
    for k in ('walker', 'accept', 'potential_energy'):
        np.testing.assert_array_equal(a[k], b[k])
    assert torch.equal(sa.positions, sb.positions) and torch.equal(sa.velocities, sb.velocities)


@pytest.mark.parametrize('mode', ['dense', 'block'])
def test_meshed_body_reads_nothing_on_the_host(water50, guard, monkeypatch, mode):  # noqa: F811
    for name in ('fixed_field_and_scf_factors_rows_plain', 'direct_energy_force_pot_rows_plain'):
        monkeypatch.setattr(ED, name, _lifted(getattr(ED, name)))
    tsys, pos = water50
    cfg = MBPolConfig.for_dynamics(cutoff=0.85, electrostatics_mode=mode)
    pot = MBPol(tsys, cfg, mesh=_cpu_mesh(2))
    sim = Simulation(pot, SimulationConfig(dt=0.0002, nlist_rebuild_interval='auto'))
    sim.set_positions(pos)
    sim.set_velocities_to_temperature(300.0)
    out = sim.step(3)
    assert len(guard) == 3 and np.all(np.isfinite(out['step_total_energy']))
    assert not _Guard.on
