"""The box as an input of every evaluation (`MBPol._energy_forces_impl(...,
box=...)`), port against the JAX package, CPU float64, water50 PME (box
1.8 nm, cutoff 0.85 nm, below half of 0.98 x 1.8). The positions at a box
s x 1.8 are the barostat's: each water's centroid scaled by s.

(a) Dense modes at 1.02 and 0.98 times the box against the JAX MBPol at the
    same box: |dE| <= 1e-6 kJ/mol for the total and each term, max |dF| <=
    1e-6 kJ/mol/nm, equal SCF iterations.
(b) Block electrostatics + pair dispersion at those boxes against the JAX
    dense evaluation, the bound of test_torch_elec_block.py (1e-6).
(c) Static-box identity: the evaluation at box b equals an MBPol built on
    system.with_box(b) with the same PME grid, alpha and list capacities
    (1e-10), in both modes; box=None and box=system.box give the same bits.
(d) Every direct-space wrapper refuses a box shorter than twice the cutoff,
    and so does an evaluation.
(e) The capacities stay those of the construction box: a shrinking box
    raises the pair count past a capacity fitted to the construction box,
    and the overflow flag says so.
(f) One monte_carlo_barostat_move with an accepted and with a rejected
    draw, the port fed the JAX key splits' two uniforms: the same decision,
    box 1e-12, positions 1e-9 nm.
(g) An NPT run of 2k steps (reports of k) equals k steps, a checkpoint
    file, a new Simulation and k more steps, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu.md import integrators as JI
from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
from mbpol_openmm_plugin_tpu.system import make_molecules_whole
from mbpol_openmm_plugin_tpu_torch.md import integrators as I
from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as BS
from mbpol_openmm_plugin_tpu_torch.ops import neighbors
from mbpol_openmm_plugin_tpu_torch.system import System

torch.set_num_threads(1)

BOX = 1.8
CUTOFF = 0.85
SCALES = (1.02, 0.98)
ATOL = 1e-6
IDENTITY_ATOL = 1e-10
CFG = dict(nonbonded_method='PME', cutoff=CUTOFF, target_epsilon=1e-7)
BLOCK = dict(electrostatics_mode='block', dispersion_mode='pairs')
TERMS = ('one_body', 'two_body', 'three_body', 'dispersion', 'electrostatics')
T_K = 300.0
DT = 0.0002


@pytest.fixture(scope='module')
def water50():
    """(port System, JAX System, whole positions [n, 3] numpy, {scale:
    (box, positions at that box)})."""
    jsys, pos = fixtures.load_system('water50', box=[BOX] * 3)
    pos = np.array(make_molecules_whole(jsys, pos))
    d = fixtures.load('water50')
    tsys = System.from_atom_names(d['names'], d['resnames'], box=[BOX] * 3)
    scaled = {}
    for s in SCALES:
        p = torch.as_tensor(pos)
        p = p + I.molecule_centroid_shift(tsys, p, s)
        scaled[s] = (np.full(3, BOX * s), p.numpy())
    return tsys, jsys, pos, scaled


@pytest.fixture(scope='module')
def jax_at_scales(water50):
    """The JAX dense evaluation at each scaled box: {scale: (E, F, parts,
    diag)}."""
    _, jsys, _, scaled = water50
    jpot = JMBPol(jsys, JConfig(**CFG))
    ef = jax.jit(jpot._energy_forces_impl)
    out = {}
    for s, (box, p) in scaled.items():
        e, f, parts, diag = ef(jnp.asarray(p), None, None, jnp.asarray(box))
        out[s] = (float(e), np.asarray(f), {k: float(v) for k, v in parts.items()},
                  int(diag['iterations']))
    return out


@pytest.mark.parametrize('modes', ['dense', 'block'])
@pytest.mark.parametrize('scale', SCALES)
def test_scaled_box_matches_jax(water50, jax_at_scales, modes, scale):
    """(a) dense and (b) block + pairs against the JAX dense evaluation."""
    tsys, _, _, scaled = water50
    box, p = scaled[scale]
    pot = MBPol(tsys, MBPolConfig(**CFG, **(BLOCK if modes == 'block' else {})), device='cpu')
    assert pot.elec_mode == modes
    e, f, parts, diag = pot._energy_forces_impl(torch.as_tensor(p), box=box)
    e_j, f_j, parts_j, it_j = jax_at_scales[scale]
    assert abs(float(e) - e_j) <= ATOL
    for k in TERMS:
        assert abs(float(parts[k]) - parts_j[k]) <= ATOL, k
    assert np.max(np.abs(f.numpy() - f_j)) <= ATOL
    assert int(diag['iterations']) == it_j and bool(diag['converged'])
    assert not any(bool(v) for k, v in diag.items() if k.endswith('_overflow'))


def _same_capacities(src: MBPol, dst: MBPol):
    """dst takes src's list capacities, triplet-build shape and block layout
    (the analytic ones depend on the construction box)."""
    cfg = src.config
    dst.pair_cap, dst.trip_cap = src.pair_cap, src.trip_cap
    dst.nlist_k_max = src.nlist_k_max or neighbors.max_neighbors(
        src.system.n_waters, src.system.box, cfg.cutoff_3b + cfg.nlist_skin)
    dst.nlist_kt = src.nlist_kt
    dst.disp_pair_cap = src.disp_pair_cap
    dst._block_info = src._block_info


@pytest.mark.parametrize('modes', ['dense', 'block'])
def test_static_box_identity(water50, modes):
    """(c) the evaluation at box b against an MBPol built in box b."""
    tsys, _, _, scaled = water50
    cfg = dict(CFG, **(BLOCK if modes == 'block' else {}))
    pot = MBPol(tsys, MBPolConfig(**cfg), device='cpu')
    p0 = torch.as_tensor(water50[2])
    e0, f0, _, _ = pot.energy_forces(p0)
    e1, f1, _, _ = pot.energy_forces(p0, box=tsys.box)
    assert torch.equal(e0, e1) and torch.equal(f0, f1)
    for box, p in scaled.values():
        fresh = MBPol(tsys.with_box(box), MBPolConfig(pme_grid=pot.pme.grid,
                                                      ewald_alpha=pot.pme.alpha, **cfg),
                      device='cpu')
        _same_capacities(pot, fresh)
        e, f, parts, _ = pot.energy_forces(torch.as_tensor(p), box=box)
        e_b, f_b, parts_b, _ = fresh.energy_forces(torch.as_tensor(p))
        assert abs(float(e) - float(e_b)) <= IDENTITY_ATOL
        assert float((f - f_b).abs().max()) <= IDENTITY_ATOL
        for k in TERMS:
            assert abs(float(parts[k]) - float(parts_b[k])) <= IDENTITY_ATOL, k


def test_short_box_is_refused(water50):
    """(d) min(box) < 2 cutoff raises in every wrapper and evaluation."""
    tsys, _, pos, _ = water50
    short = (1.6, 1.8, 1.8)
    c = ED.DirectConsts(alpha=3.0, cutoff=CUTOFF, thole=(0.4, 0.4, 0.055, 0.626, 0.055),
                        box=short)
    sites = torch.zeros((8, ED.NS), dtype=torch.float64)
    mu = torch.zeros((8, 3), dtype=torch.float64)
    sites_bs = torch.zeros((BS.TILE, ED.NS), dtype=torch.float64)
    for call in (lambda: ED.fixed_field_and_scf_factors(sites, c),
                 lambda: ED.direct_energy_force_pot(sites, mu, c),
                 lambda: BS.fixed_field_and_scf_lines(sites_bs, 8, None, c),
                 lambda: BS.scf_dipole_field_bs(sites_bs, None, None, None, 8, c),
                 lambda: BS.direct_energy_force_pot_bs(sites_bs, mu, 8, None, c)):
        with pytest.raises(ValueError, match='twice the direct-space cutoff'):
            call()
    for modes in ({}, BLOCK):
        pot = MBPol(tsys, MBPolConfig(**CFG, **modes), device='cpu')
        with pytest.raises(ValueError, match='twice the direct-space cutoff'):
            pot.energy_forces(torch.as_tensor(pos), box=short)
    # exactly twice the cutoff is the shortest box taken
    ED.DirectConsts(alpha=3.0, cutoff=0.9, thole=c.thole, box=(1.8, 1.8, 1.8)).check_box()


def test_shrinking_box_sets_the_overflow_flag(water50):
    """(e) pair_cap fitted to the construction box's count overflows at 0.98
    of the box, and diag says so."""
    tsys, _, pos, scaled = water50
    pot = MBPol(tsys, MBPolConfig(**CFG), device='cpu')
    _, _, diag = pot._neighbor_lists(torch.as_tensor(pos))
    n0 = int(diag['n_pairs'])
    pot.pair_cap = n0
    box, p = scaled[0.98]
    _, _, diag = pot._neighbor_lists(torch.as_tensor(p), box)
    assert int(diag['n_pairs']) > n0 and bool(diag['pair_overflow'])
    assert bool(pot.energy_forces(torch.as_tensor(p), box=box)[3]['pair_overflow'])


def test_barostat_move_matches_jax(water50, jax_at_scales):
    """(f) an accepted and a rejected move, found among the JAX keys 0, 1,
    ...; the port is fed the same two uniforms."""
    tsys, jsys, pos, _ = water50
    vel = np.array(JI.maxwell_boltzmann_velocities(jsys, T_K, jax.random.PRNGKey(7)))
    jef = jax.jit(JMBPol(jsys, JConfig(**CFG))._energy_forces_impl)
    box0 = jnp.asarray(jsys.box)
    e0, f0, _, _ = jef(jnp.asarray(pos), None, None, box0)
    scale = 0.01 * BOX ** 3
    pot = MBPol(tsys, MBPolConfig(**CFG), device='cpu')

    def tstate():
        return I.MDState(positions=torch.as_tensor(pos), velocities=torch.as_tensor(vel),
                         forces=torch.as_tensor(np.array(f0)),
                         potential_energy=torch.tensor(float(e0), dtype=torch.float64),
                         box=np.array(tsys.box), step=0)

    seen = set()
    for seed in range(12):
        key = jax.random.PRNGKey(seed)
        jstate = JI.MDState(positions=jnp.asarray(pos), velocities=jnp.asarray(vel), forces=f0,
                            potential_energy=e0, box=box0, step=jnp.zeros((), jnp.int32),
                            rng=key)
        js, j_acc = JI.monte_carlo_barostat_move(
            jsys, lambda p, box: jef(p, None, None, box)[0], jstate, T_K, 1.0, scale)
        j_acc = bool(j_acc)
        if j_acc in seen:
            continue
        seen.add(j_acc)
        _, k1, k2 = jax.random.split(key, 3)
        u = torch.as_tensor(np.array([jax.random.uniform(k1), jax.random.uniform(k2)]))
        ts, t_acc = I.monte_carlo_barostat_move(
            tsys, lambda p, box: pot._energy_forces_impl(p, box=box)[:2], tstate(), T_K, 1.0,
            scale, u)
        assert t_acc == j_acc
        np.testing.assert_allclose(ts.box, np.asarray(js.box), rtol=0, atol=1e-12)
        assert np.max(np.abs(ts.positions.numpy() - np.asarray(js.positions))) <= 1e-9
        assert abs(float(ts.potential_energy) - float(js.potential_energy)) <= ATOL
        assert j_acc != np.array_equal(ts.box, tsys.box)
        if len(seen) == 2:
            break
    assert seen == {True, False}


def test_npt_checkpoint_resume_is_bit_identical(water50, tmp_path):
    """(g) with the Langevin generator and the adaptive barostat's state in
    the checkpoint."""
    tsys, _, pos, _ = water50
    k = 4
    cfg = SimulationConfig(dt=DT, temperature=T_K, thermostat='langevin', friction=10.0,
                           barostat_pressure=1.0, barostat_interval=2,
                           nlist_rebuild_interval='auto', cm_motion_interval=1)

    def new_sim():
        return Simulation(MBPol(tsys, MBPolConfig.for_dynamics(cutoff=CUTOFF), device='cpu'),
                          cfg, seed=9)

    a = new_sim()
    a.set_positions(pos)
    a.set_velocities_to_temperature(T_K)
    out_a = a.step(2 * k, report_interval=k)
    assert out_a['barostat_attempted'] == 2 * k // cfg.barostat_interval

    b = new_sim()
    b.set_positions(pos)
    b.set_velocities_to_temperature(T_K)
    b.step(k)
    b.save_checkpoint(tmp_path / 'npt.npz')
    c = new_sim()
    c.load_checkpoint_file(tmp_path / 'npt.npz')
    c.step(k)
    assert c.state.step == a.state.step == 2 * k
    for name in ('positions', 'velocities', 'forces', 'potential_energy'):
        assert torch.equal(getattr(c.state, name), getattr(a.state, name)), name
    assert np.array_equal(c.state.box, a.state.box)
    assert c._baro == a._baro
    assert torch.equal(c.generator.get_state(), a.generator.get_state())
