"""Three velocity-Verlet steps under MBPolConfig.for_dynamics() at water50,
port against the same loop through the JAX package's _energy_forces_impl
(the bench.py step body: ASPC dipole history, displacement-triggered list
rebuild). CPU float64; positions agree to 1e-9 nm.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import fixtures
from mbpol_openmm_plugin_tpu.models import electrostatics as jelec
from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
from mbpol_openmm_plugin_tpu.system import make_molecules_whole
from mbpol_openmm_plugin_tpu_torch.md import integrators as I
from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.system import System

torch.set_num_threads(1)

N_STEPS = 3
DT = 0.0002   # ps


def jax_trajectory(jsys, pos, n_steps):
    """The bench.py md_chunk body, eager per step with a jitted evaluation."""
    pot = JMBPol(jsys, JConfig.for_dynamics())
    ef = jax.jit(pot._energy_forces_impl)
    masses = np.asarray(jsys.masses)
    inv_m = jnp.asarray(np.where(masses > 0, 1.0 / np.where(masses > 0, masses, 1.0), 0.0))[:, None]
    B = jnp.asarray(jelec.aspc_predictor_coefficients(3))
    skin = pot.config.nlist_skin
    o = np.asarray(jsys.o_index)

    e, f, _, d = pot.energy_forces(pos)
    hist = jnp.tile(d['induced_dipoles'][None], (len(B), 1, 1))
    p_build = pos
    nl, _ = pot.build_neighbor_lists(pos)
    v = jnp.zeros_like(pos)
    traj = []
    for _ in range(n_steps):
        v_half = v + 0.5 * DT * f * inv_m
        p = pos + DT * v_half
        disp = float(jnp.max(jnp.linalg.norm(p[o] - p_build[o], axis=-1)))
        if 2.0 * disp > 0.5 * skin:
            nl, _ = pot.build_neighbor_lists(p)
            p_build = p
        e, f, _, d = ef(p, jnp.einsum('h,hnd->nd', B, hist), nlists=nl)
        hist = jnp.roll(hist, 1, axis=0).at[0].set(d['induced_dipoles'])
        v = v_half + 0.5 * DT * f * inv_m
        pos = p
        traj.append((np.asarray(pos), np.asarray(v), float(e)))
    return traj


def test_three_verlet_steps_match_jax():
    jsys, jpos = fixtures.load_system('water50', box=[1.8] * 3)
    jpos = make_molecules_whole(jsys, jpos)
    ref = jax_trajectory(jsys, jpos, N_STEPS)

    d = fixtures.load('water50')
    tsys = System.from_atom_names(d['names'], d['resnames'], box=[1.8] * 3)
    sim = Simulation(MBPol(tsys, MBPolConfig.for_dynamics(), device='cpu'),
                     SimulationConfig(dt=DT, nlist_rebuild_interval='auto'))
    sim.set_positions(torch.as_tensor(np.array(jpos)))
    out = sim.step(N_STEPS)
    pos_j, vel_j, e_j = ref[-1]
    np.testing.assert_allclose(sim.state.positions.numpy(), pos_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(sim.state.velocities.numpy(), vel_j, rtol=0, atol=1e-6)
    assert abs(out['potential_energy'][-1] - e_j) <= 1e-6
    assert sim.state.step == N_STEPS
    e_steps = out['step_total_energy']
    assert e_steps.shape == (N_STEPS + 1,)
    np.testing.assert_allclose(e_steps[-1], out['total_energy'][-1], rtol=1e-12)
    t = float(I.temperature(tsys, sim.state.velocities))
    np.testing.assert_allclose(out['temperature'][-1], t, rtol=1e-12)
