"""The port's sparse (water-pair list) PME electrostatics
(models/pme_sparse.py) and the site-chunked PME grid pieces
(models/pme._spread_separable / _readback_phi10), CPU float64.

(a) pme_electrostatics_sparse against the JAX function on water50 (box
    1.8 nm, cutoff 0.9 nm, the same pair list): the cold SOR loop and one
    ASPC step from a given predictor; energy rtol 1e-9, forces atol 1e-8
    kJ/mol/nm, dipoles atol 1e-10 e nm.
(b) the port's sparse mode against its dense mode on water50 and water256,
    at the JAX package's bounds (tests/test_pme_sparse.py).
(c) MBPol(electrostatics_mode='sparse') against the JAX MBPol in that mode,
    per term (1e-6 kJ/mol) and forces (1e-6 kJ/mol/nm); tune_capacities'
    elec_pair_cap against the JAX one on water256.
(d) 'auto' on the CPU above 512 waters: water50 repeated 2 x 2 x 3 (600
    waters, the PME grid the small box's (28^3) times the repeats) resolves to
    'sparse' / 'pairs' and evaluates to 12 x the small box's energy (1e-9
    relative).
(e) the chunked spread and read-back (_SEP_CHUNK_ELEMS set to 1: chunks of
    256 sites; 600 sites so that the last chunk is short) against the
    single-shot ones (atol 1e-12) and against the JAX functions chunked the
    same way.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu.models import electrostatics as JE
from mbpol_openmm_plugin_tpu.models import pme as JP
from mbpol_openmm_plugin_tpu.models import pme_sparse as JPS
from mbpol_openmm_plugin_tpu.ops import neighbors as JN
from mbpol_openmm_plugin_tpu.system import System as JSystem
from mbpol_openmm_plugin_tpu.system import compute_virtual_sites as j_vsites
from mbpol_openmm_plugin_tpu.system import make_molecules_whole as j_whole
from mbpol_openmm_plugin_tpu_torch.models import electrostatics as E
from mbpol_openmm_plugin_tpu_torch.models import pme as P
from mbpol_openmm_plugin_tpu_torch.models import pme_sparse as PS
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.system import System, make_molecules_whole, replicate

torch.set_num_threads(1)

BOX50 = [1.8] * 3
BOX256 = [19.3996888399961804 / 10.0] * 3
TERMS = ('one_body', 'two_body', 'three_body', 'dispersion', 'electrostatics')


def _inputs(name, n_mol, box, **params):
    """(JAX params, setup, positions; port params, setup, positions; the
    JAX pair list and mask) of a fixture with the M sites placed."""
    jsys = JSystem.waters(n_mol, box=box)
    jpos = j_vsites(jsys, j_whole(jsys, jnp.asarray(fixtures.load(name)['positions'])))
    jparams = JE.ElecParams.for_system(jsys, target_epsilon=1e-8, **params)
    tol = 1e-4
    alpha = float(np.sqrt(-np.log(2 * tol)) / 0.9)
    grid = tuple(int(np.ceil(2 * alpha * b / (3 * tol ** 0.2))) for b in box)
    jsetup = JP.PmeSetup(alpha=alpha, grid=grid, cutoff=0.9, box=tuple(box))
    cut = 0.9 + JPS.PAIR_MARGIN
    cap = JN.pair_capacity(n_mol, box, cut, factor=2.0)
    pairs, mask, n = JN.pair_list(jpos[jsys.o_index], box, cut, cap)
    assert int(n) <= cap
    tsys = System.waters(n_mol, box=box)
    tparams = E.ElecParams.for_system(tsys, target_epsilon=1e-8, **params)
    tsetup = P.PmeSetup(alpha=alpha, grid=grid, cutoff=0.9, box=tuple(box))
    tpos = torch.as_tensor(np.array(jpos))
    return (jparams, jsetup, jpos), (tparams, tsetup, tpos), (pairs, mask)


def _lists_t(pairs, mask):
    return torch.as_tensor(np.array(pairs), dtype=torch.int64), torch.as_tensor(np.array(mask))


@pytest.mark.parametrize('closure', ['sor', 'aspc'])
def test_sparse_matches_jax_water50(closure):
    kw = dict(scf_method='aspc', aspc_k=3) if closure == 'aspc' else {}
    (jparams, jsetup, jpos), (tparams, tsetup, tpos), (pairs, mask) = _inputs(
        'water50', 50, BOX50, **kw)
    mu0 = None
    if closure == 'aspc':
        # a predictor near the fixed point: the converged dipoles, perturbed
        rng = np.random.default_rng(3)
        mu_ref = JPS.pme_electrostatics_sparse(
            JE.ElecParams.for_system(JSystem.waters(50, box=BOX50), target_epsilon=1e-8),
            jsetup, jpos, pairs, mask)[2]['induced_dipoles']
        mu0 = np.array(mu_ref) * (1.0 + 0.01 * rng.standard_normal(mu_ref.shape))
    ej, fj, dj = JPS.pme_electrostatics_sparse(jparams, jsetup, jpos, pairs, mask,
                                               mu0=None if mu0 is None else jnp.asarray(mu0))
    et, ft, dt = PS.pme_electrostatics_sparse(tparams, tsetup, tpos, *_lists_t(pairs, mask),
                                              mu0=None if mu0 is None else torch.as_tensor(mu0))
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-9)
    assert np.max(np.abs(ft.numpy() - np.asarray(fj))) <= 1e-8
    assert np.max(np.abs(dt['induced_dipoles'].numpy() - np.asarray(dj['induced_dipoles']))) \
        <= 1e-10
    assert int(dt['iterations']) == int(dj['iterations'])
    if closure == 'sor':
        assert bool(dt['converged']) and bool(dj['converged'])
    else:
        assert int(dt['iterations']) == 1


@pytest.mark.parametrize('name,n_mol,box', [('water50', 50, BOX50),
                                            ('water256_integration_test', 256, BOX256)])
def test_sparse_matches_dense(name, n_mol, box):
    _, (tparams, tsetup, tpos), (pairs, mask) = _inputs(name, n_mol, box)
    e_d, f_d, d_d = P.pme_electrostatics(tparams, tsetup, tpos)
    e_s, f_s, d_s = PS.pme_electrostatics_sparse(tparams, tsetup, tpos, *_lists_t(pairs, mask))
    assert bool(d_s['converged'])
    np.testing.assert_allclose(float(e_s), float(e_d), rtol=1e-9)
    np.testing.assert_allclose(f_s.numpy(), f_d.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d_s['induced_dipoles'].numpy(), d_d['induced_dipoles'].numpy(),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(d_s['site_potential'].numpy(), d_d['site_potential'].numpy(),
                               rtol=1e-6, atol=1e-8)


def test_mbpol_sparse_matches_jax():
    from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
    from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
    jsys, jpos = fixtures.load_system('water50', box=BOX50)
    cfg = dict(nonbonded_method='PME', cutoff=0.9, electrostatics_mode='sparse')
    jpot = JMBPol(jsys, JConfig(**cfg))
    ej, fj, pj, dj = jpot.energy_forces(jpos)
    d = fixtures.load('water50')
    tsys = System.from_atom_names(d['names'], d['resnames'], box=BOX50)
    tpot = MBPol(tsys, MBPolConfig(**cfg), device='cpu')
    assert (tpot.elec_mode, tpot.disp_mode) == (jpot.elec_mode, jpot.disp_mode) == \
        ('sparse', 'pairs')
    assert tpot.elec_pair_cap == jpot.elec_pair_cap and tpot.disp_pair_cap is None
    et, ft, pt, dt = tpot.energy_forces(np.array(jpos))
    for k in TERMS:
        assert abs(float(pt[k]) - float(pj[k])) <= 1e-6, k
    assert np.max(np.abs(ft.numpy() - np.asarray(fj))) <= 1e-6
    assert int(dt['iterations']) == int(dj['iterations'])
    for k in ('elec_pair_overflow', 'disp_pair_overflow', 'pair_overflow', 'triplet_overflow'):
        assert bool(dt[k]) == bool(dj[k]) is False, k


def test_tune_capacities_elec_pair_cap_matches_jax():
    from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
    from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
    jsys, jpos = fixtures.load_system('water256_integration_test', box=BOX256)
    cfg = dict(electrostatics_mode='sparse')
    jpot = JMBPol(jsys, JConfig.for_dynamics(**cfg)).tune_capacities(jpos)
    d = fixtures.load('water256_integration_test')
    tsys = System.from_atom_names(d['names'], d['resnames'], box=BOX256)
    tpot = MBPol(tsys, MBPolConfig.for_dynamics(**cfg), device='cpu')
    analytic = tpot.elec_pair_cap
    tpot.tune_capacities(np.array(jpos))
    assert tpot.elec_pair_cap == jpot.elec_pair_cap < analytic
    assert tpot.disp_pair_cap is None is jpot.disp_pair_cap
    for name in ('pair_cap', 'trip_cap', 'nlist_k_max', 'nlist_kt'):
        assert getattr(tpot, name) == getattr(jpot, name), name


def test_auto_above_512_waters_is_sparse_on_the_cpu():
    d = fixtures.load('water50')
    small = System.from_atom_names(d['names'], d['resnames'], box=BOX50)
    # the copies converge in the same SOR iterations at any target
    cfg = dict(nonbonded_method='PME', cutoff=0.9, target_epsilon=1e-5)
    # an even grid: the moduli's zeta correction wraps an odd grid's
    # frequencies at (n - 1) / 2 and the replicated grid's at n / 2, which
    # moves the energy by ~3e-7 relative; even grids wrap alike
    pot_s = MBPol(small, MBPolConfig(pme_grid=(28, 28, 28), **cfg), device='cpu')
    # whole molecules: a water split across the small box stays split in the big one
    pos = make_molecules_whole(small, torch.as_tensor(np.array(d['positions'])))
    e_s = float(pot_s.energy_forces(pos)[0])
    reps = (2, 2, 3)
    big, pos_big = replicate(small, pos, reps)
    grid = tuple(g * r for g, r in zip(pot_s.pme.grid, reps))
    pot_b = MBPol(big, MBPolConfig(pme_grid=grid, **cfg), device='cpu')
    assert big.n_waters == 600
    assert (pot_b.elec_mode, pot_b.disp_mode) == ('sparse', 'pairs')
    assert pot_b.pme.alpha == pot_s.pme.alpha
    e_b, f_b, _, diag = pot_b.energy_forces(pos_big)
    assert bool(diag['converged'])
    assert not any(bool(v) for k, v in diag.items() if k.endswith('_overflow'))
    assert abs(float(e_b) / 12 - e_s) <= 1e-9 * abs(e_s)
    assert torch.all(torch.isfinite(f_b))


def _grid_inputs():
    rng = np.random.default_rng(7)
    n, dims = 600, (8, 6, 10)
    box = (1.2, 1.1, 1.3)
    pos = rng.uniform(0, 1.1, (n, 3))
    wx = rng.normal(size=(n, dims[0]))
    return n, dims, box, pos, wx


def test_chunked_grid_matches_single_shot_and_jax(monkeypatch):
    n, dims, box, pos, wx = _grid_inputs()
    tsetup = P.PmeSetup(alpha=3.0, grid=dims, cutoff=0.9, box=box)
    jsetup = JP.PmeSetup(alpha=3.0, grid=dims, cutoff=0.9, box=box)
    S = P._spline_matrices(tsetup, torch.as_tensor(pos), box)
    wx_t = torch.as_tensor(wx)
    ref_grid = P._spread_separable(tsetup, wx_t, S[1][..., 0], S[2][..., 0])
    ref_back = P._readback_phi10(ref_grid, *S)
    JS = JP._spline_matrices(jsetup, jnp.asarray(pos))

    monkeypatch.setattr(P, '_SEP_CHUNK_ELEMS', 1)
    monkeypatch.setattr(JP, '_SEP_CHUNK_ELEMS', 1)
    assert P._sep_chunk(n, dims[1] * dims[2]) == JP._sep_chunk(n, dims[1] * dims[2]) == 256
    grid_c = P._spread_separable(tsetup, wx_t, S[1][..., 0], S[2][..., 0])
    back_c = P._readback_phi10(ref_grid, *S)
    np.testing.assert_allclose(grid_c.numpy(), ref_grid.numpy(), atol=1e-12)
    np.testing.assert_allclose(back_c.numpy(), ref_back.numpy(), atol=1e-12)
    j_grid = JP._spread_separable(jsetup, jnp.asarray(wx), JS[1][..., 0], JS[2][..., 0])
    j_back = JP._readback_phi10(jnp.asarray(ref_grid.numpy()), *JS)
    np.testing.assert_allclose(grid_c.numpy(), np.asarray(j_grid), atol=1e-12)
    np.testing.assert_allclose(back_c.numpy(), np.asarray(j_back), atol=1e-12)
