"""The port's cluster (NoCutoff) path against the JAX package, CPU float64.

- cluster_electrostatics on water3 (4-site, charge redistribution), the
  3-site water3 of test_electrostatics_cluster.py and the water14 cluster:
  energy within 1e-9 kJ/mol, forces 1e-8 kJ/mol/nm, induced dipoles 1e-10
  e nm, equal SOR iteration counts; the 3-site goldens (-7.08652 kcal/mol
  within 7.1e-4, per-atom forces 2e-4 kcal/mol/A) as the JAX test holds
  them.
- DIIS against the JAX DIIS: equal iteration counts, dipoles within 1e-9,
  and fewer iterations than SOR.
- system_moments (1e-9 of the largest entry) and
  electrostatic_potential_on_grid at 64 points (1e-9 kJ/mol/e).
- MBPol(NoCutoff) per term within 1e-8 kJ/mol of the JAX MBPol on water3
  (total -8.78893485 +/- 0.1 kcal/mol) and the water14 cluster, forces
  1e-8; water3 forces against central differences of the energy (rtol
  5e-5, atol 1e-4, as test_potential_cluster.py); a non-contiguous site
  layout (each water stored as H1, O, M, H2) equal to the standard one
  and to JAX within the same bounds, the JAX potential given the per-site
  parameters of that layout (its ElecParams.for_system tiles the OHHM
  values whatever the layout; see ROADMAP.md section 3).
- The flat-bottom restraint against JAX flat_bottom_energy (1e-12), its
  forces sum to zero (1e-10), MBPol with the restraint against JAX, and
  the PBC ValueError.
- water + Cl- with terms one_body/two_body/three_body/dispersion against
  JAX (1e-10), and the ValueError for ions with electrostatics.
- tune_capacities on a 50-water cluster (no box) gives the JAX tuned
  capacities.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu.models import electrostatics as JE
from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
from mbpol_openmm_plugin_tpu.models.restraint import flat_bottom_energy as jax_restraint
from mbpol_openmm_plugin_tpu.system import System as JSystem
from mbpol_openmm_plugin_tpu_torch.models import electrostatics as E
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.models.restraint import flat_bottom_energy
from mbpol_openmm_plugin_tpu_torch.system import System, compute_virtual_sites
from mbpol_openmm_plugin_tpu_torch.utils import units

torch.set_num_threads(1)

KCAL = units.KJ_PER_MOL_TO_KCAL_PER_MOL
WATER3_POS9 = np.array([
    [-1.516074336e+00, -2.023167650e-01, 1.454672917e+00],
    [-6.218989773e-01, -6.009430735e-01, 1.572437625e+00],
    [-2.017613812e+00, -4.190350349e-01, 2.239642849e+00],
    [-1.763651687e+00, -3.816594649e-01, -1.300353949e+00],
    [-1.903851736e+00, -4.935677617e-01, -3.457810126e-01],
    [-2.527904158e+00, -7.613550077e-01, -1.733803676e+00],
    [-5.588472140e-01, 2.006699172e+00, -1.392786582e-01],
    [-9.411558180e-01, 1.541226676e+00, 6.163293071e-01],
    [-9.858551734e-01, 1.567124294e+00, -8.830970941e-01],
]) * 0.1
GOLDEN_W3_FORCES_KCAL_A = np.array([
    [-3.19433, 2.43239, -10.3645], [2.85289, -1.05713, 1.48109],
    [0.0173808, -0.452184, 2.42326], [1.70128, 3.95891, -3.18597],
    [0.245021, 0.703767, 8.78742], [-0.131845, -0.335554, 0.790616],
    [2.88521, 4.3743, 1.63126], [-2.57406, -4.43219, -0.234785],
    [-1.80153, -5.1923, -1.32836]])


def T(x):
    return torch.as_tensor(np.array(x))


def three_site_params(mod, **kw):
    """The 3-site water3 parameters of test_electrostatics_cluster.py."""
    damping = np.tile([0.001310, 0.000294, 0.000294], 3)
    return mod.ElecParams(
        thole=np.full(5, 0.4), damping=damping, polarity=damping.copy(),
        mol_index=np.repeat(np.arange(3), 3), atom_type=np.tile([0, 1, 1], 3),
        charges=np.tile([-5.1966000e-01, 2.5983000e-01, 2.5983000e-01], 3),
        include_charge_redistribution=False, target_epsilon=1e-9, **kw)


def elec_case(name, **kw):
    """(JAX params, port params, positions numpy) for an electrostatics case."""
    if name == 'water3_3site':
        return three_site_params(JE, **kw), three_site_params(E, **kw), WATER3_POS9
    jsys, pos = fixtures.load_system(name)
    d = fixtures.load(name)
    tsys = System.from_atom_names(d['names'], d['resnames'])
    return (JE.ElecParams.for_system(jsys, **kw), E.ElecParams.for_system(tsys, **kw),
            np.array(pos))


CASES = ['water3', 'water3_3site', 'water14_cluster']


@pytest.mark.parametrize('name', CASES)
def test_cluster_electrostatics_matches_jax(name):
    jp, tp, pos = elec_case(name)
    ej, fj, dj = JE.cluster_electrostatics(jp, jnp.asarray(pos))
    et, ft, dt = E.cluster_electrostatics(tp, T(pos))
    assert abs(float(et) - float(ej)) <= 1e-9
    assert np.max(np.abs(ft.numpy() - np.asarray(fj))) <= 1e-8
    assert np.max(np.abs(dt['induced_dipoles'].numpy() - np.asarray(dj['induced_dipoles']))) \
        <= 1e-10
    assert int(dt['iterations']) == int(dj['iterations'])
    assert bool(dt['converged'])


def test_three_site_goldens():
    _, tp, pos = elec_case('water3_3site')
    e, f, diag = E.cluster_electrostatics(tp, T(pos))
    assert bool(diag['converged'])
    assert abs(float(e) * KCAL - (-7.08652)) < 1e-4 * 7.1
    f_kcal_a = f.numpy() * KCAL / units.NM_TO_ANGSTROM
    np.testing.assert_allclose(f_kcal_a, GOLDEN_W3_FORCES_KCAL_A, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize('name', CASES)
def test_diis_matches_jax_diis(name):
    jp, tp, pos = elec_case(name, scf_method='diis')
    _, _, dj = JE.cluster_electrostatics(jp, jnp.asarray(pos))
    _, _, dt = E.cluster_electrostatics(tp, T(pos))
    _, _, d_sor = E.cluster_electrostatics(dataclasses.replace(tp, scf_method='sor'), T(pos))
    assert int(dt['iterations']) == int(dj['iterations']) < int(d_sor['iterations'])
    assert bool(dt['converged'])
    assert np.max(np.abs(dt['induced_dipoles'].numpy() - np.asarray(dj['induced_dipoles']))) \
        <= 1e-9


def test_moments_and_grid_potential_match_jax():
    jp, tp, pos = elec_case('water14_cluster')
    masses = np.asarray(fixtures.load_system('water14_cluster')[0].masses)
    mj = np.asarray(JE.system_moments(jp, jnp.asarray(pos), masses))
    mt = E.system_moments(tp, T(pos), masses).numpy()
    assert mt.shape == (13,)
    assert np.max(np.abs(mt - mj)) <= 1e-9 * np.max(np.abs(mj))
    rng = np.random.default_rng(0)
    grid = pos[::4].mean(axis=0) + rng.uniform(-0.8, 0.8, (64, 3))
    pj = np.asarray(JE.electrostatic_potential_on_grid(jp, jnp.asarray(pos), jnp.asarray(grid)))
    pt = E.electrostatic_potential_on_grid(tp, T(pos), T(grid)).numpy()
    assert pt.shape == (64,)
    assert np.max(np.abs(pt - pj)) <= 1e-9


def load_pair(name, **cfg):
    """(JAX MBPol, port MBPol, positions numpy) for a cluster fixture."""
    jsys, pos = fixtures.load_system(name)
    d = fixtures.load(name)
    tsys = System.from_atom_names(d['names'], d['resnames'])
    cfg = dict(nonbonded_method='NoCutoff', **cfg)
    return JMBPol(jsys, JConfig(**cfg)), MBPol(tsys, MBPolConfig(**cfg), device='cpu'), \
        np.array(pos)


def assert_matches(jpot, tpot, pos, e_tol=1e-8, f_tol=1e-8):
    ej, fj, pj, _ = jpot.energy_forces(jnp.asarray(pos))
    et, ft, pt, _ = tpot.energy_forces(pos)
    assert set(pt) == set(pj)
    for k in pj:
        assert abs(float(pt[k]) - float(pj[k])) <= e_tol, (k, float(pt[k]), float(pj[k]))
    assert abs(float(et) - float(ej)) <= e_tol
    assert np.max(np.abs(ft.numpy() - np.asarray(fj))) <= f_tol
    return float(et), ft.numpy()


@pytest.mark.parametrize('name', ['water3', 'water14_cluster'])
def test_mbpol_nocutoff_matches_jax(name):
    jpot, tpot, pos = load_pair(name, cutoff=0.9)
    e, f = assert_matches(jpot, tpot, pos)
    assert np.all(np.isfinite(f))
    if name == 'water3':
        assert abs(e * KCAL - (-8.78893485)) < 0.1


def test_mbpol_nocutoff_forces_finite_difference():
    _, tpot, pos = load_pair('water3', cutoff=0.9, target_epsilon=1e-10)
    _, f, _, _ = tpot.energy_forces(pos)
    rng = np.random.default_rng(0)
    h = 2e-6
    for _ in range(4):
        i = int(rng.integers(0, tpot.system.n_atoms))
        i -= int(i % 4 == 3)          # M coordinates are overwritten by the placement
        d = int(rng.integers(0, 3))
        p1, p2 = pos.copy(), pos.copy()
        p1[i, d] += h
        p2[i, d] -= h
        fd = -(float(tpot.energy_forces(p1)[0]) - float(tpot.energy_forces(p2)[0])) / (2 * h)
        np.testing.assert_allclose(float(f[i, d]), fd, rtol=5e-5, atol=1e-4)


def permuted(system_cls, sys_, order=(1, 0, 3, 2)):
    """sys_ with each water stored as its sites in `order` of (O, H1, H2, M)
    (default H1, O, M, H2), and the row permutation new <- old."""
    n = sys_.n_waters
    perm = (4 * np.arange(n)[:, None] + np.asarray(order)[None, :]).reshape(-1)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    new = system_cls(
        n_waters=n, n_ions=0, atom_class=sys_.atom_class[perm], mol_index=sys_.mol_index[perm],
        masses=sys_.masses[perm], o_index=inv[sys_.o_index].astype(np.int32),
        h1_index=inv[sys_.h1_index].astype(np.int32),
        h2_index=inv[sys_.h2_index].astype(np.int32),
        m_index=inv[sys_.m_index].astype(np.int32), ion_index=sys_.ion_index, box=None)
    return new, perm


def test_noncontiguous_layout_matches_standard_and_jax():
    jsys, pos = fixtures.load_system('water14_cluster')
    d = fixtures.load('water14_cluster')
    tsys = System.from_atom_names(d['names'], d['resnames'])
    jnew, perm = permuted(JSystem, jsys)
    tnew, _ = permuted(System, tsys)
    cfg = dict(nonbonded_method='NoCutoff')
    pos = np.array(pos)
    e_std, f_std, _, _ = MBPol(tsys, MBPolConfig(**cfg), device='cpu').energy_forces(pos)
    tpot = MBPol(tnew, MBPolConfig(**cfg), device='cpu')
    ep = tpot.elec_params
    jpot = JMBPol(jnew, JConfig(**cfg)).with_updated_params(
        charges=ep.charges, damping=ep.damping, polarity=ep.polarity)
    e, f = assert_matches(jpot, tpot, pos[perm])
    assert abs(e - float(e_std)) <= 1e-8
    assert np.max(np.abs(f - f_std.numpy()[perm])) <= 1e-8
    np.testing.assert_array_equal(f[tnew.m_index], 0.0)
    placed = compute_virtual_sites(tnew, T(pos[perm])).numpy()
    np.testing.assert_allclose(placed, pos[perm], atol=1e-12)


def test_restraint_matches_jax_and_sums_to_zero():
    o = np.random.default_rng(2).uniform(-0.5, 0.5, (6, 3))
    r, k = 0.3, 400.0
    et = flat_bottom_energy(T(o), r, k)
    assert abs(float(et) - float(jax_restraint(jnp.asarray(o), r, k))) <= 1e-12
    p = T(o).requires_grad_(True)
    g, = torch.autograd.grad(flat_bottom_energy(p, r, k), p)
    gj = np.asarray(jax.grad(jax_restraint)(jnp.asarray(o), r, k))
    assert np.abs(g.numpy()).max() > 0
    assert np.max(np.abs(g.numpy() - gj)) <= 1e-12
    assert np.max(np.abs(g.numpy().sum(axis=0))) <= 1e-10
    # a site at the centroid keeps a finite gradient
    p = torch.zeros((3, 3), dtype=torch.float64, requires_grad=True)
    g, = torch.autograd.grad(flat_bottom_energy(p, 0.1, k), p)
    assert bool(torch.isfinite(g).all())


def test_mbpol_restraint_matches_jax_and_refuses_pbc():
    jpot, tpot, pos = load_pair('water14_cluster', restraint_radius=0.3, restraint_k=1000.0)
    assert_matches(jpot, tpot, pos)
    _, _, parts, _ = tpot.energy_forces(pos)
    assert float(parts['restraint']) > 0
    with pytest.raises(ValueError, match='restraint'):
        MBPol(System.waters(3, box=[1.9] * 3),
              MBPolConfig(nonbonded_method='PME', restraint_radius=0.5), device='cpu')


def test_water_and_ion_matches_jax():
    terms = ('one_body', 'two_body', 'three_body', 'dispersion')
    jpot, tpot, pos = load_pair('water_and_ion', terms=terms)
    assert tpot.system.n_ions == 1
    assert_matches(jpot, tpot, pos, e_tol=1e-10, f_tol=1e-10)
    with pytest.raises(ValueError, match='water-only'):
        MBPol(tpot.system, MBPolConfig(nonbonded_method='NoCutoff'), device='cpu')


def test_tune_capacities_cluster_matches_jax():
    jsys, pos = fixtures.load_system('water50', box=[1.8] * 3)
    from mbpol_openmm_plugin_tpu.system import make_molecules_whole
    pos = np.array(make_molecules_whole(jsys, pos))
    jpot = JMBPol(jsys.with_box(None), JConfig(nonbonded_method='NoCutoff'))
    jpot.tune_capacities(jnp.asarray(pos))
    d = fixtures.load('water50')
    tpot = MBPol(System.from_atom_names(d['names'], d['resnames']),
                 MBPolConfig(nonbonded_method='NoCutoff'), device='cpu')
    assert tpot.use_neighbor_lists
    tpot.tune_capacities(pos)
    for name in ('pair_cap', 'trip_cap', 'nlist_k_max', 'nlist_kt'):
        assert getattr(tpot, name) == getattr(jpot, name), name
