"""The port's MD example applications (mbpol_openmm_plugin_tpu_torch/
examples/) against the JAX package's scripts, CPU float64, the JAX draws
fed in where the scripts draw (isotope_density: test_torch_examples_npt.py).

- water256_pimd (examples/water256_pimd.py:68-95): the contracted 2 -> 1
  step on water50 PME (box 1.8 nm, cutoff 0.85 nm), the start from
  initial_state + contracted_energy_forces and 4 steps of the script's
  chunk (step, then KE_virial), fed the JAX key's normals: positions 1e-10
  nm, the bead-summed PE and KE_virial 1e-8 kJ/mol;
- water14_pimd (examples/water14_pimd.py:50-66): 2 full beads, 3 steps, the
  beads started with bead 0's forces: the same bounds;
- water2048_scaling (examples/water2048_scaling.py:48-60): water50 x
  (2, 1, 1), each mode's single point after tune_capacities: the port's
  dense and sparse against the JAX package's, its block (the kernels' plain
  twins) against the JAX dense mode (the JAX block mode runs Pallas kernels
  that the CPU only interprets, on TPU-sized tiles), 1e-8 kJ/mol
  (energies) and 1e-8 of max|F| (forces), and the warm evaluation's
  energy equal to the first;
- multichip_scaling (examples/multichip_scaling.py:60-91): the same box,
  plan_capacities(n_devices=2) from the positions: every integer field
  against the JAX planner's; the port's MBPol(mesh=2 CPU shards, plan=)
  single point against the JAX potential's, and its Verlet loop: finite,
  the same steps twice from one start bit for bit;
- water14 (examples/water14.py): the app single point and forces against
  the JAX app's (1e-8 kcal/mol, 1e-8 of max|F|) and 5 minimizer
  iterations against the JAX app's minimizer; the NVE tail finite (its
  velocities are drawn from a torch.Generator).
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
from mbpol_openmm_plugin_tpu.parallel.plan import plan_capacities as j_plan
from mbpol_openmm_plugin_tpu.system import System as JSystem
from mbpol_openmm_plugin_tpu.system import compute_virtual_sites as jvsites
from mbpol_openmm_plugin_tpu.system import make_molecules_whole as jwhole
from mbpol_openmm_plugin_tpu_torch.examples import (_common, multichip_scaling, water14,
                                                    water14_pimd, water256_pimd,
                                                    water2048_scaling)
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.system import System

torch.set_num_threads(1)

BOX50 = 1.8
W50 = dict(nonbonded_method='PME', cutoff=0.85, target_epsilon=1e-3, max_iterations=200,
           nlist_skin=0.02)
INT_FIELDS = ('n_waters', 'n_devices', 'pair_cap', 'trip_cap', 'pair_eval_cap',
              'trip_eval_cap', 'nlist_k_max', 'nlist_kt', 'elec_pair_cap', 'disp_pair_cap')


@pytest.fixture(scope='module')
def water50():
    """(names, resnames, whole positions with the M sites placed) of water50
    in its 1.8 nm box."""
    d = fixtures.load('water50')
    jsys = JSystem.from_atom_names(d['names'], d['resnames'], box=[BOX50] * 3)
    pos = np.asarray(jvsites(jsys, jwhole(jsys, jnp.asarray(d['positions']))))
    return d['names'], d['resnames'], pos


def _jax_normals(seed):
    """normal(shape, like) drawing what the JAX scripts draw from
    PRNGKey(seed): initial_state's spread from its first split, then each
    step's O normals from a split of the state key."""
    key, k_spread = jax.random.split(jax.random.PRNGKey(seed))
    chain = [key, k_spread]

    def normal(shape, like):
        if chain[1] is not None:
            k, chain[1] = chain[1], None
        else:
            chain[0], k = jax.random.split(chain[0])
        return torch.as_tensor(np.array(jax.random.normal(k, shape, jnp.float64)))
    return normal


def _jax_chunk(jsys, step, state, n_steps, temperature):
    """The scripts' scan body (water256_pimd.py:86-92): a step, then the
    centroid-virial KE; (state, summed PE [n], KE [n])."""
    def chunk(s, _):
        s = step(s)
        return s, (jnp.sum(s.potential_energy),
                   JR.kinetic_energy_virial(jsys, s.positions, s.forces, temperature))
    state, (pes, kes) = jax.jit(lambda s: jax.lax.scan(chunk, s, None, length=n_steps))(state)
    return state, np.asarray(pes), np.asarray(kes)


# ----------------------------------------------------------------------
# the functional ring-polymer examples
# ----------------------------------------------------------------------

def test_water256_pimd_contracted_step_matches_jax(water50):
    names, resnames, pos = water50
    box = [BOX50] * 3
    n, nc, steps = 2, 1, 4
    T, DT, TAU0 = water256_pimd.T, water256_pimd.DT, water256_pimd.TAU0
    jsys = JSystem.from_atom_names(names, resnames, box=box)
    jpot = JMBPol(jsys, JConfig(**W50))
    jpot.tune_capacities(jnp.asarray(pos))
    step = JR.make_rpmd_contracted_potential_step(jpot, n, nc, DT, T, tau0=TAU0)
    ef_intra, ef_inter = JR.mbpol_intra_inter_split(jpot)
    ef_all = JR.contracted_energy_forces(ef_inter, ef_intra, n, nc)
    jstate = JR.initial_state(jsys, jnp.asarray(pos), n, T, jax.random.PRNGKey(0), box=box,
                              spread=0.002)
    e0, f0 = jax.jit(ef_all)(jstate.positions)
    jstate = dataclasses.replace(jstate, forces=f0, potential_energy=e0)
    jstate, jpes, jkes = _jax_chunk(jsys, step, jstate, steps, T)

    sys_ = System.from_atom_names(names, resnames, box=box)
    pot = MBPol(sys_, MBPolConfig(**W50), device='cpu')
    pot.tune_capacities(pos)
    normal = _jax_normals(0)
    tstep, state = water256_pimd.ring_polymer(pot, torch.as_tensor(pos), n, nc, T, DT, TAU0,
                                              normal, box=box)
    assert np.max(np.abs(state.forces.numpy() - np.asarray(f0))) <= 1e-8
    state, pes, kes = water256_pimd.trajectory(sys_, tstep, state, steps, T, normal)
    assert np.max(np.abs(state.positions.numpy() - np.asarray(jstate.positions))) <= 1e-10
    assert np.max(np.abs(pes.numpy() - jpes)) <= 1e-8
    assert np.max(np.abs(kes.numpy() - jkes)) <= 1e-8


def test_water14_pimd_matches_jax():
    n, steps = 2, 3
    T = water14_pimd.T
    jsys = JSystem.waters(14)
    jpos = jvsites(jsys, jnp.asarray(fixtures.load('water14_cluster')['positions']))
    jpot = JMBPol(jsys, JConfig(nonbonded_method='NoCutoff', target_epsilon=1e-5))
    step = JR.make_rpmd_potential_step(jpot, n, water14_pimd.DT, T, tau0=water14_pimd.TAU0)
    jstate = JR.initial_state(jsys, jpos, n, T, jax.random.PRNGKey(0), spread=0.002)
    e, f, _, _ = jax.jit(jpot._energy_forces_impl)(jstate.positions[0])
    jstate = dataclasses.replace(
        jstate, forces=jnp.broadcast_to(f[None], jstate.positions.shape).copy(),
        potential_energy=jnp.broadcast_to(e[None], (n,)).copy())
    jstate, _, jkes = _jax_chunk(jsys, step, jstate, steps, T)

    out = water14_pimd.run(n, steps, device='cpu', normal=_jax_normals(0), echo=False)
    assert np.max(np.abs(np.asarray(out['ke_virial']) - jkes)) <= 1e-8
    assert abs(out['pe_bead_mean_kcal'] - float(jnp.mean(jstate.potential_energy)) / 4.184) \
        <= 1e-8
    assert out['ke_classical_kcal'] > 0 and np.isfinite(out['ratio'])


# ----------------------------------------------------------------------
# the scaling harnesses on a small replicated box
# ----------------------------------------------------------------------

@pytest.fixture(scope='module')
def water100(water50):
    """water50 x (2, 1, 1): (port System, JAX System, positions, box)."""
    pos, box = _common.replicate(water50[2], BOX50, (2, 1, 1))
    return System.waters(100, box=box), JSystem.waters(100, box=box), pos, box


@pytest.fixture(scope='module')
def jax_dense(water100):
    """The JAX script's single point (water2048_scaling.py:57) in the dense
    mode: (E, F)."""
    _, jsys, pos, _ = water100
    jpot = JMBPol(jsys, JConfig(**W50, electrostatics_mode='dense'))
    jpot.tune_capacities(jnp.asarray(pos))
    e, f, _, _ = jpot._energy_forces(jnp.asarray(pos))
    return float(e), np.asarray(f)


@pytest.mark.parametrize('mode', ['dense', 'block', 'sparse'])
def test_water2048_scaling_modes_match_jax(water100, jax_dense, mode):
    sys_, jsys, pos, _ = water100
    cfg = dict(W50)
    out = water2048_scaling.mode_run(sys_, pos, mode, 'cpu', n_warm=1, config=cfg, echo=False)
    assert out['mode'] == mode and out['converged'] and not any(out['overflow'].values())
    if mode == 'sparse':
        jpot = JMBPol(jsys, JConfig(**W50, electrostatics_mode='sparse'))
        jpot.tune_capacities(jnp.asarray(pos))
        e, f, _, _ = jpot._energy_forces(jnp.asarray(pos))
        ref = float(e), np.asarray(f)
    else:
        ref = jax_dense
    assert abs(out['energy'] - ref[0]) <= 1e-8
    assert np.max(np.abs(out['forces'] - ref[1])) <= 1e-8 * np.max(np.abs(ref[1]))
    assert out['warm_eval_ms'] > 0


def test_multichip_scaling_plan_and_mesh_match_jax(water100, jax_dense):
    sys_, _, pos, box = water100
    cfg = MBPolConfig(**W50)
    tsys, plan, mesh, pot, tpos = multichip_scaling.planned_potential(pos, box, 2, 'cpu',
                                                                     cfg=cfg)
    jp = j_plan(100, box, n_devices=2, config=JConfig(**W50), positions=pos, pallas_ok=False)
    for name in INT_FIELDS:
        assert getattr(plan, name) == getattr(jp, name), name
    assert (plan.elec_mode, plan.disp_mode, plan.pme_grid) == (jp.elec_mode, jp.disp_mode,
                                                                 jp.pme_grid)
    assert mesh.size == 2 and pot.mesh is mesh
    e, f, _, diag = pot.energy_forces(tpos)
    assert bool(diag['converged'])
    assert abs(float(e) - jax_dense[0]) <= 1e-8
    assert np.max(np.abs(f.numpy() - jax_dense[1])) <= 1e-8 * np.max(np.abs(jax_dense[1]))
    nl, _ = pot.build_neighbor_lists(tpos)
    mu = diag['induced_dipoles']
    p1, es1 = multichip_scaling.verlet(pot, tpos, f, mu, nl, 2)
    p2, es2 = multichip_scaling.verlet(pot, tpos, f, mu, nl, 2)
    assert torch.isfinite(es1).all() and torch.equal(es1, es2) and torch.equal(p1, p2)
    assert float(torch.max(torch.abs(p1 - tpos))) > 0


# ----------------------------------------------------------------------
# the app-layer example
# ----------------------------------------------------------------------

def test_water14_app_example_matches_jax(tmp_path):
    from mbpol_openmm_plugin_tpu import app as japp
    from mbpol_openmm_plugin_tpu.app import unit as junit
    out = water14.run('cpu', min_iterations=5, nve_steps=2, pdb_dir=str(tmp_path), echo=False)
    pdb = japp.PDBFile(str(tmp_path / 'water14_cluster.pdb'))
    system = japp.ForceField(japp.mbpol_xml_path()).createSystem(
        pdb.topology, nonbondedMethod=japp.CutoffNonPeriodic,
        nonbondedCutoff=1e3 * junit.nanometer)
    sim = japp.Simulation(pdb.topology, system, japp.VerletIntegrator(0.2 * junit.femtoseconds))
    sim.context.setPositions(pdb.positions)
    sim.context.computeVirtualSites()
    state = sim.context.getState(getForces=True, getEnergy=True)
    e0 = state.getPotentialEnergy().value_in_unit(junit.kilocalorie_per_mole)
    kcal_a = junit.kilocalorie_per_mole / junit.angstrom
    f0 = np.asarray([f.value_in_unit(kcal_a) for f in state.getForces()])
    assert abs(out['potential_energy_kcal'] - e0) <= 1e-8
    assert np.max(np.abs(out['forces_kcal_per_A'] - f0)) <= 1e-8 * np.max(np.abs(f0))
    sim.minimizeEnergy(maxIterations=5)
    e_min = sim.context.getState(getEnergy=True).getPotentialEnergy().value_in_unit(
        junit.kilocalorie_per_mole)
    assert abs(out['minimized_kcal'] - e_min) <= 1e-8 and e_min < e0
    assert np.isfinite(out['final_pe_kcal'])
