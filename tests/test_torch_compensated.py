"""Compensated accumulation (utils/compensated.py) and the port's drift tool
(tools/nve_drift.py).

- comp_add against the JAX package's in float32, bit for bit, over 10^4
  seeded triples (x, c, dx), with |x| >> |dx| and with |dx| >> |x|;
- the drift tool's step (DriftRun, --kahan and plain) against the JAX
  tool's scan body (tools/nve_drift.py, md_chunk: compensated half kick
  and drift, the displacement-triggered rebuild, the ASPC evaluation, the
  compensated second half kick), written here over the JAX package's
  functions: 10 steps of water50 (box 1.8 nm, cutoff 0.85 nm, skin 0.004
  nm so the trigger fires), CPU float64, positions within 1e-12 nm.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu.md import integrators as JI
from mbpol_openmm_plugin_tpu.models import electrostatics as JE
from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
from mbpol_openmm_plugin_tpu.system import make_molecules_whole
from mbpol_openmm_plugin_tpu.utils.compensated import comp_add as j_comp_add
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.system import System
from mbpol_openmm_plugin_tpu_torch.tools.nve_drift import DriftRun
from mbpol_openmm_plugin_tpu_torch.utils.compensated import comp_add, comp_zero_like

torch.set_num_threads(1)

BOX = [1.8] * 3
N_STEPS = 10
DT = 0.0002


@pytest.mark.parametrize('x_dominates', [True, False])
def test_comp_add_matches_jax_bit_for_bit(x_dominates):
    rng = np.random.default_rng(11 if x_dominates else 12)
    n = 10_000
    big = rng.uniform(-2.0, 2.0, n) * 10.0 ** rng.uniform(-1, 1, n)
    small = rng.standard_normal(n) * 10.0 ** rng.uniform(-7, -3, n)
    x, dx = (big, small) if x_dominates else (small, big)
    c = rng.standard_normal(n) * 1e-8
    x, c, dx = (a.astype(np.float32) for a in (x, c, dx))
    t, c_new = comp_add(torch.as_tensor(x), torch.as_tensor(c), torch.as_tensor(dx))
    jt, jc = j_comp_add(jnp.asarray(x), jnp.asarray(c), jnp.asarray(dx))
    assert t.dtype == torch.float32 and np.asarray(jt).dtype == np.float32
    np.testing.assert_array_equal(t.numpy().view(np.int32), np.asarray(jt).view(np.int32))
    np.testing.assert_array_equal(c_new.numpy().view(np.int32), np.asarray(jc).view(np.int32))
    if x_dominates:
        # a position's update: the pair carries what the float32 add rounds away
        exact = x.astype(np.float64) + c + dx
        err_comp = np.abs(t.numpy().astype(np.float64) + c_new.numpy() - exact)
        err_plain = np.abs((x + c + dx).astype(np.float64) - exact)
        assert err_comp.max() <= 1e-3 * err_plain.max()
    assert torch.equal(comp_zero_like(t), torch.zeros_like(t))


def _jax_drift_steps(jpot, jsys, pos, vel, kahan, n_steps):
    """The JAX tool's md_chunk body, step by step (the lax.cond of the
    rebuild taken on the host)."""
    skin = jpot.config.nlist_skin
    masses = np.asarray(jsys.masses, np.float64)
    inv_m = jnp.asarray(np.where(masses > 0, 1.0 / np.where(masses > 0, masses, 1.0), 0.0))[:, None]
    o_idx = np.asarray(jsys.o_index)
    B = jnp.asarray(JE.aspc_predictor_coefficients(jpot.config.aspc_k))
    rebuild = jax.jit(lambda p: jpot._neighbor_lists(make_molecules_whole(jsys, p)))
    evaluate = jax.jit(lambda p, mu0, nl: jpot._energy_forces_impl(p, mu0, nlists=nl))
    e0, f, _, diag0 = jpot.energy_forces(pos)
    mu_hist = jnp.tile(diag0['induced_dipoles'][None], (len(B), 1, 1))
    nlists, _ = jpot.build_neighbor_lists(pos)
    p, v, p_build = pos, vel, pos
    vc, pc = jnp.zeros_like(v), jnp.zeros_like(p)
    fired = 0
    for _ in range(n_steps):
        dv1 = 0.5 * DT * f * inv_m
        if kahan:
            v_half, vc = j_comp_add(v, vc, dv1)
            p, pc = j_comp_add(p, pc, DT * v_half)
        else:
            v_half = v + dv1
            p = p + DT * v_half
        disp = jnp.max(jnp.linalg.norm(p[o_idx] - p_build[o_idx], axis=-1))
        if bool(2.0 * disp > 0.5 * skin):
            pl, tl, _ = rebuild(p)
            nlists, p_build = (pl, tl), p
            fired += 1
        mu0 = jnp.einsum('h,hnd->nd', B, mu_hist)
        _, f, _, diag = evaluate(p, mu0, nlists)
        mu_hist = jnp.roll(mu_hist, 1, axis=0).at[0].set(diag['induced_dipoles'])
        dv2 = 0.5 * DT * f * inv_m
        if kahan:
            v, vc = j_comp_add(v_half, vc, dv2)
        else:
            v = v_half + dv2
    return np.asarray(p), np.asarray(v), fired


@pytest.mark.parametrize('kahan', [True, False])
def test_drift_step_matches_the_jax_tool(kahan):
    jsys, jpos = fixtures.load_system('water50', box=BOX)
    jpos = make_molecules_whole(jsys, jpos)
    vel = JI.maxwell_boltzmann_velocities(jsys, 300.0, jax.random.PRNGKey(3))
    kw = dict(cutoff=0.85, nlist_skin=0.004)
    jpot = JMBPol(jsys, JConfig.for_dynamics(**kw))
    p_j, v_j, fired = _jax_drift_steps(jpot, jsys, jpos, vel, kahan, N_STEPS)
    assert 1 <= fired < N_STEPS

    d = fixtures.load('water50')
    tsys = System.from_atom_names(d['names'], d['resnames'], box=BOX)
    pot = MBPol(tsys, MBPolConfig.for_dynamics(**kw), device='cpu')
    md = DriftRun(pot, np.array(jpos), np.array(vel), DT, kahan)
    md.steps(N_STEPS)
    b = md.graph.buffers
    assert np.max(np.abs(b['positions'].numpy() - p_j)) <= 1e-12
    assert np.max(np.abs(b['velocities'].numpy() - v_j)) <= 1e-9
    assert not md.overflow()
    assert bool(torch.any(b['pc'] != 0)) == kahan
