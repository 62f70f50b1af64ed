"""The port's virial pressure (mbpol_openmm_plugin_tpu_torch/md/pressure.py)
against the JAX package's, CPU float64.

Both take dU/dlambda as a derivative: the JAX package by forward-mode
autodiff through the box, the port by autograd through a tensor lambda
with the induced dipoles of a converged evaluation held
(models/pme.pme_variational_energy). On the periodic water14 box of
tests/test_pressure.py the two agree within 1e-6 of |dU/dlambda|
(measured 1.3e-7; the JAX potential's SCF target there is 1e-8); on the
water50 box, where site pairs lie within 1e-4 of the 0.85 nm cutoff so
that a central difference sees their jumps, within 1e-8 (measured
2.1e-10, both SCF targets 1e-10). The variational energy equals the
converged electrostatic energy at lambda = 1, and its direct space gives
the same derivative in one chunk of rows or in many. The other four tests
of tests/test_pressure.py are mirrored on the port: the kinetic and
temperature forms, the dilute-gas limit (three waters 2 nm apart in a
6 nm box, where the JAX test spreads them 4 nm apart in a 12 nm box: an
eighth of the PME grid), the cluster refusal, and the ring-polymer form
at one bead, in the dilute gas and against the JAX function on two beads.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu.md import pressure as JPR
from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
from mbpol_openmm_plugin_tpu.system import System as JSystem
from mbpol_openmm_plugin_tpu.system import compute_virtual_sites as jvsites
from mbpol_openmm_plugin_tpu.system import make_molecules_whole as jwhole
from mbpol_openmm_plugin_tpu_torch.md import pressure as PR
from mbpol_openmm_plugin_tpu_torch.models import pme as PME
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig, with_scf_method
from mbpol_openmm_plugin_tpu_torch.ops import elec_direct
from mbpol_openmm_plugin_tpu_torch.system import (System, compute_virtual_sites,
                                                  make_molecules_whole)
from mbpol_openmm_plugin_tpu_torch.utils import units

torch.set_num_threads(1)

BOX14 = [1.6, 1.6, 1.6]
CFG14 = dict(nonbonded_method='PME', cutoff=0.7, target_epsilon=1e-8, max_iterations=300)
DU_REL = 1e-6
BOX50 = 1.8
CFG50 = dict(nonbonded_method='PME', cutoff=0.85, target_epsilon=1e-10, max_iterations=500)
DU_REL50 = 1e-8
DILUTE_BOX = 6.0


@pytest.fixture(scope='module')
def water14_periodic():
    """(port potential, JAX potential, positions) of tests/test_pressure.py's
    _water14_periodic."""
    d = fixtures.load('water14')
    jsys = JSystem.waters(14, box=BOX14)
    pos = np.asarray(jvsites(jsys, jnp.asarray(d['positions'] + 0.8)))
    jpot = JMBPol(jsys, JConfig(**CFG14))
    jpot.tune_capacities(jnp.asarray(pos))
    pot = MBPol(System.waters(14, box=BOX14), MBPolConfig(**CFG14), device='cpu')
    pot.tune_capacities(pos)
    return pot, jpot, pos


@pytest.fixture(scope='module')
def jax_readings(water14_periodic):
    """The JAX package's dU/dlambda (its jitted jvp) and pressures on the
    periodic water14 box: velocity and temperature forms."""
    _, jpot, pos = water14_periodic
    vel = np.random.default_rng(5).normal(0, 0.5, pos.shape)
    p_v = float(JPR.virial_pressure(jpot, jnp.asarray(pos), velocities=jnp.asarray(vel),
                                    box=BOX14))
    p_t = float(JPR.virial_pressure(jpot, jnp.asarray(pos), temperature_k=300.0, box=BOX14))
    du = float(jpot._virial_du_jit(jnp.asarray(pos), jnp.asarray(BOX14)))
    return dict(vel=vel, p_v=p_v, p_t=p_t, du=du)


def test_du_dlambda_matches_jax_jvp(water14_periodic, jax_readings):
    pot, _, pos = water14_periodic
    du_j = jax_readings['du']
    du = PR.du_dlambda(pot, torch.as_tensor(pos)[None], np.asarray(BOX14))
    assert abs(du - du_j) <= DU_REL * abs(du_j), (du, du_j)


@pytest.fixture(scope='module')
def water50():
    """(port potential, whole positions, the JAX package's dU/dlambda and
    temperature-form pressure) on water50 in a 1.8 nm box."""
    d = fixtures.load('water50')
    jsys = JSystem.from_atom_names(d['names'], d['resnames'], box=[BOX50] * 3)
    pos = np.array(jvsites(jsys, jwhole(jsys, jnp.asarray(d['positions']))))
    jpot = JMBPol(jsys, JConfig(**CFG50))
    jpot.tune_capacities(jnp.asarray(pos))
    p_t = float(JPR.virial_pressure(jpot, jnp.asarray(pos), temperature_k=300.0))
    du = float(jpot._virial_du_jit(jnp.asarray(pos), jnp.asarray([BOX50] * 3)))
    pot = MBPol(System.from_atom_names(d['names'], d['resnames'], box=[BOX50] * 3),
                MBPolConfig(**CFG50), device='cpu')
    pot.tune_capacities(pos)
    return pot, pos, du, p_t


def _cutoff_margin(pot, pos):
    """The smallest |r - cutoff| over the intermolecular site pairs (nm)."""
    x = torch.as_tensor(pos)
    box = torch.as_tensor(pot.system.box)
    d = x[None] - x[:, None]
    r = torch.linalg.norm(d - torch.round(d / box) * box, dim=-1)
    mol = torch.as_tensor(np.asarray(pot.system.mol_index))
    other = mol[None] != mol[:, None]
    return float(torch.min(torch.abs(r[other] - pot.config.cutoff)))


def test_du_dlambda_matches_jax_jvp_across_the_cutoff(water50):
    """Where site pairs sit at the direct-space cutoff (within 1e-4 nm, so
    a central difference with h = 1e-4 would difference their jumps), the
    port's derivative is the JAX jvp's, and so is the pressure."""
    pot, pos, du_j, p_j = water50
    assert _cutoff_margin(pot, pos) < 1e-4
    du = PR.du_dlambda(pot, torch.as_tensor(pos)[None], np.asarray([BOX50] * 3))
    assert abs(du - du_j) <= DU_REL50 * abs(du_j), (du, du_j)
    p = PR.virial_pressure(pot, pos, temperature_k=300.0)
    tol = DU_REL50 * abs(du_j) / (3 * BOX50 ** 3 * PR.BAR_IN_KJ_MOL_NM3)
    assert abs(p - p_j) <= tol, (p, p_j)


def test_variational_energy_is_the_converged_energy(water50):
    """pme_variational_energy at the converged dipoles equals the
    electrostatic energy of the evaluation (1e-9 relative; the SCF at
    1e-10 leaves its residual squared)."""
    pot, pos, _, _ = water50
    p = with_scf_method(pot, 'sor', target_epsilon=1e-10, scf_eps_floor=1e-10)
    _, _, parts, diag = p._energy_forces_impl(torch.as_tensor(pos))
    sites = compute_virtual_sites(p.system, make_molecules_whole(p.system, torch.as_tensor(pos)))
    e = PME.pme_variational_energy(p.elec_params, p.pme, sites, diag['induced_dipoles'], None)
    np.testing.assert_allclose(float(e), float(parts['electrostatics']), rtol=1e-9)


def test_du_dlambda_direct_space_in_chunks(water50, monkeypatch):
    """The direct space of the derivative in chunks of 7 rows (checkpointed
    one by one) gives the one-chunk value (1e-12 relative)."""
    pot, pos, _, _ = water50
    q = torch.as_tensor(pos)[None]
    whole = PR.du_dlambda(pot, q, np.asarray([BOX50] * 3))
    monkeypatch.setattr(elec_direct, 'TRI_CHUNK', 7 * pos.shape[0])
    chunked = PR.du_dlambda(pot, q, np.asarray([BOX50] * 3))
    np.testing.assert_allclose(chunked, whole, rtol=1e-12)


def test_virial_pressure_matches_jax_kinetic_and_temperature(water14_periodic, jax_readings):
    """Both kinetic forms against the JAX function; each is the
    hand-assembled (2 K_com - dU/dlambda) / 3V."""
    pot, _, pos = water14_periodic
    vel = jax_readings['vel']
    du = PR.du_dlambda(pot, torch.as_tensor(pos)[None], np.asarray(BOX14))
    p = PR.virial_pressure(pot, pos, velocities=vel, box=BOX14)
    vcom, mol_mass = PR._molecular_coms(pot.system, torch.as_tensor(vel))
    twice_k = float(torch.sum(mol_mass[:, None] * vcom * vcom))
    vol_bar = 3 * 1.6 ** 3 * PR.BAR_IN_KJ_MOL_NM3
    np.testing.assert_allclose(p, (twice_k - du) / vol_bar, rtol=1e-12)
    tol = DU_REL * abs(du) / vol_bar
    assert abs(p - jax_readings['p_v']) <= tol, (p, jax_readings['p_v'])
    p_t = PR.virial_pressure(pot, pos, temperature_k=300.0, box=BOX14)
    assert abs(p_t - jax_readings['p_t']) <= tol, (p_t, jax_readings['p_t'])
    ideal = 3 * 14 * units.BOLTZMANN_KJ_MOL_K * 300.0
    np.testing.assert_allclose(p_t, (ideal - du) / vol_bar, rtol=1e-12)


def _dilute_water3():
    """Three waters ~2 nm apart in a 6 nm PME box."""
    full = np.array(fixtures.load('water3')['positions'])
    for k, off in enumerate(([1.0] * 3, [3.0] * 3, [5.0] * 3)):
        full[4 * k:4 * k + 4] += np.asarray(off)
    sys_ = System.waters(3, box=[DILUTE_BOX] * 3)
    pos = compute_virtual_sites(sys_, torch.as_tensor(full))
    pot = MBPol(sys_, MBPolConfig(nonbonded_method='PME', cutoff=0.9, target_epsilon=1e-8,
                                  max_iterations=100), device='cpu')
    pot.tune_capacities(pos)
    return sys_, pos, pot


IDEAL_BAR = 3 * units.BOLTZMANN_KJ_MOL_K * 300.0 / DILUTE_BOX ** 3 / PR.BAR_IN_KJ_MOL_NM3


def test_dilute_gas_limit_is_ideal():
    """P -> N_mol kT / V within the JAX test's 25% (PME self/background
    terms)."""
    _, pos, pot = _dilute_water3()
    p = PR.virial_pressure(pot, pos, temperature_k=300.0)
    assert abs(p - IDEAL_BAR) < 0.25 * IDEAL_BAR, (p, IDEAL_BAR)


def test_cluster_raises():
    pot = MBPol(System.waters(3), MBPolConfig(nonbonded_method='NoCutoff'), device='cpu')
    with pytest.raises(ValueError, match='periodic'):
        PR.virial_pressure(pot, torch.zeros(12, 3), temperature_k=300.0)
    with pytest.raises(ValueError, match='periodic'):
        PR.rpmd_virial_pressure(pot, torch.zeros(2, 12, 3), 300.0)


def test_needs_velocities_or_temperature(water14_periodic):
    pot, _, pos = water14_periodic
    with pytest.raises(ValueError, match='velocities or temperature'):
        PR.virial_pressure(pot, pos)


def test_rpmd_pressure_reduces_to_classical_at_one_bead(water14_periodic):
    pot, jpot, pos = water14_periodic
    p_cl = PR.virial_pressure(pot, pos, temperature_k=300.0)
    p_rp = PR.rpmd_virial_pressure(pot, torch.as_tensor(pos)[None], 300.0)
    np.testing.assert_allclose(p_rp, p_cl, rtol=1e-12)


def test_rpmd_pressure_dilute_gas_is_ideal():
    """Four beads with a 0.005 nm spread on the dilute waters: the rigid
    shift leaves the intra-bead geometry alone, so P -> N_mol kT / V
    (25%)."""
    sys_, pos, pot = _dilute_water3()
    q = pos.numpy()[None] + _spread(sys_, pos, 4, 0.005, 3)
    q = torch.stack([compute_virtual_sites(sys_, torch.as_tensor(x)) for x in q])
    p = PR.rpmd_virial_pressure(pot, q, 300.0)
    assert abs(p - IDEAL_BAR) < 0.25 * IDEAL_BAR, (p, IDEAL_BAR)


def _spread(sys_, pos, n, scale, seed):
    real = np.asarray(sys_.masses)[None, :, None] > 0
    return np.where(real, scale * np.random.default_rng(seed).standard_normal(
        (n,) + tuple(pos.shape)), 0.0)


def test_rpmd_pressure_matches_jax(water14_periodic):
    """Two beads, 0.002 nm apart, on the periodic water14 box: the port's
    ring-polymer pressure against the JAX function, 1e-6 of the dU/dlambda
    part."""
    pot, jpot, pos = water14_periodic
    q = pos[None] + _spread(pot.system, pos, 2, 0.002, 4)
    p = PR.rpmd_virial_pressure(pot, torch.as_tensor(q), 300.0)
    p_j = float(JPR.rpmd_virial_pressure(jpot, jnp.asarray(q), 300.0))
    du = PR.du_dlambda(pot, torch.as_tensor(q), np.asarray(BOX14))
    assert abs(p - p_j) <= DU_REL * abs(du) / (3 * 1.6 ** 3 * PR.BAR_IN_KJ_MOL_NM3), (p, p_j)
