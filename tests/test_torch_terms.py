"""The PyTorch port's force terms against the JAX package, CPU float64.

Same inputs (fixtures, or numpy with a fixed seed) go through each JAX
function and its port. Bounds: rtol/atol 1e-10 on energies and other
values, 1e-8 on gradients. The reference goldens of test_one_body.py,
test_two_body.py and test_three_body.py are reproduced by the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu import system as jsystem
from mbpol_openmm_plugin_tpu.models import dispersion as jdisp
from mbpol_openmm_plugin_tpu.models import electrostatics as jelec
from mbpol_openmm_plugin_tpu.models import one_body as j1b
from mbpol_openmm_plugin_tpu.models import three_body as j3b
from mbpol_openmm_plugin_tpu.models import two_body as j2b
from mbpol_openmm_plugin_tpu.ops import bspline as jbs
from mbpol_openmm_plugin_tpu.ops import gamma as jgamma
from mbpol_openmm_plugin_tpu.ops import neighbors as jnb
from mbpol_openmm_plugin_tpu_torch import system as tsystem
from mbpol_openmm_plugin_tpu_torch.models import dispersion as tdisp
from mbpol_openmm_plugin_tpu_torch.models import electrostatics as telec
from mbpol_openmm_plugin_tpu_torch.models import one_body as t1b
from mbpol_openmm_plugin_tpu_torch.models import three_body as t3b
from mbpol_openmm_plugin_tpu_torch.models import two_body as t2b
from mbpol_openmm_plugin_tpu_torch.ops import bspline as tbs
from mbpol_openmm_plugin_tpu_torch.ops import gamma as tgamma
from mbpol_openmm_plugin_tpu_torch.ops import neighbors as tnb
from test_one_body import GOLDEN_ENERGY_KCAL as G1, WATER1_GRAD_KCAL_A, WATER1_POS
from test_three_body import GOLDEN_ENERGY_KCAL as G3, WATER3_GRAD_KCAL_A, WATER3_POS
from test_two_body import GOLDEN_ENERGY_KCAL as G2, WATER2_GRAD_KCAL_A, WATER2_POS

torch.set_num_threads(1)

KCAL = 1.0 / 4.184
E_TOL = dict(rtol=1e-10, atol=1e-10)
F_TOL = dict(rtol=1e-8, atol=1e-8)


def T(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def t_grad(fn, pos):
    p = T(pos).requires_grad_(True)
    e = fn(p)
    (g,) = torch.autograd.grad(e, p)
    return float(e.detach()), g.numpy()


def water50_box():
    jsys, jpos = fixtures.load_system('water50', box=[1.8] * 3)
    jpos = jsystem.make_molecules_whole(jsys, jpos)
    d = fixtures.load('water50')
    tsys = tsystem.System.from_atom_names(d['names'], d['resnames'], box=[1.8] * 3)
    return jsys, tsys, np.asarray(jpos)


def _full(pos_w):
    """Stride-4 OHHM positions (M = 0) from [nmol*3, 3] O,H1,H2 rows."""
    n = len(pos_w) // 3
    full = np.zeros((4 * n, 3))
    full[np.arange(4 * n) % 4 != 3] = pos_w
    return n, full


# ----------------------------------------------------------------------
# reference goldens, reproduced by the port
# ----------------------------------------------------------------------

def test_one_body_golden():
    e, g = t_grad(lambda p: t1b.one_body_energy(p[None]).sum(), WATER1_POS)
    assert abs(e * KCAL - G1) < 1e-6
    np.testing.assert_allclose(g * KCAL / 10.0, WATER1_GRAD_KCAL_A, atol=2e-4)


@pytest.mark.parametrize('term', ['two_body', 'three_body'])
def test_pip_goldens(term):
    pos, golden, grad_ref, fn = {
        'two_body': (WATER2_POS, G2, WATER2_GRAD_KCAL_A, t2b.two_body_energy),
        'three_body': (WATER3_POS, G3, WATER3_GRAD_KCAL_A, t3b.three_body_energy)}[term]
    n, full = _full(pos)
    sys_ = tsystem.System.waters(n)
    e, g = t_grad(lambda p: fn(sys_, p), full)
    assert abs(e * KCAL - golden) < 1e-6
    real = np.arange(4 * n) % 4 != 3
    np.testing.assert_allclose(g[real] * KCAL / 10.0, grad_ref, atol=2e-4)
    np.testing.assert_allclose(g[~real], 0.0, atol=1e-12)


# ----------------------------------------------------------------------
# port vs JAX on the same inputs
# ----------------------------------------------------------------------

def test_one_body_vs_jax_water50():
    jsys, tsys, pos = water50_box()
    wj = jsystem.water_positions(jsys, jnp.asarray(pos))
    e_j = np.asarray(jax.jit(j1b.one_body_energy)(wj))
    g_j = np.asarray(jax.jit(jax.grad(lambda w: j1b.one_body_energy(w).sum()))(wj))
    w = T(np.asarray(wj)).requires_grad_(True)
    e_t = t1b.one_body_energy(w)
    (g_t,) = torch.autograd.grad(e_t.sum(), w)
    np.testing.assert_allclose(e_t.detach().numpy(), e_j, **E_TOL)
    np.testing.assert_allclose(g_t.numpy(), g_j, **F_TOL)


@pytest.mark.parametrize('term', ['two_body', 'three_body'])
def test_pip_terms_vs_jax_water50(term):
    """Energies and the analytic-gradient autograd.Function against jax.grad
    of the JAX term, over all pairs/triplets of water50 in its PME box."""
    jsys, tsys, pos = water50_box()
    jfn = {'two_body': j2b.two_body_energy, 'three_body': j3b.three_body_energy}[term]
    tfn = {'two_body': t2b.two_body_energy, 'three_body': t3b.three_body_energy}[term]
    if term == 'three_body':   # the listed triplets (all 19600 would be slow)
        o = jnp.asarray(pos[0::4])
        box = np.asarray([1.8] * 3)
        trip, mask, _ = jnb.triplet_list(o, box, 0.47, jnb.triplet_capacity(50, box, 0.47))
        trip = np.asarray(trip)[np.asarray(mask)]
        e_j, g_j = jax.jit(jax.value_and_grad(lambda p: jfn(jsys, p, trip)))(jnp.asarray(pos))
        e_t, g_t = t_grad(lambda p: tfn(tsys, p, torch.as_tensor(trip)), pos)
    else:
        e_j, g_j = jax.jit(jax.value_and_grad(lambda p: jfn(jsys, p)))(jnp.asarray(pos))
        e_t, g_t = t_grad(lambda p: tfn(tsys, p), pos)
    assert abs(float(e_j)) > 1.0
    np.testing.assert_allclose(e_t, float(e_j), **E_TOL)
    np.testing.assert_allclose(g_t, np.asarray(g_j), **F_TOL)


@pytest.mark.parametrize('switch_width', [0.0, 0.1])
def test_dispersion_vs_jax_water50(switch_width):
    jsys, tsys, pos = water50_box()
    pos_v = np.asarray(jsystem.compute_virtual_sites(jsys, jnp.asarray(pos)))
    e_j, g_j = jax.value_and_grad(lambda p: jdisp.dispersion_energy(
        jsys, p, cutoff=0.85, switch_width=switch_width))(jnp.asarray(pos_v))
    e_t, g_t = t_grad(lambda p: tdisp.dispersion_energy(
        tsys, p, cutoff=0.85, switch_width=switch_width), pos_v)
    np.testing.assert_allclose(e_t, float(e_j), **E_TOL)
    np.testing.assert_allclose(g_t, np.asarray(g_j), **F_TOL)


def test_system_helpers_vs_jax():
    jsys, tsys, pos = water50_box()
    rng = np.random.default_rng(1)
    wrapped = pos + 1.8 * rng.integers(-1, 2, size=pos.shape)     # broken molecules
    np.testing.assert_allclose(
        tsystem.make_molecules_whole(tsys, T(wrapped)).numpy(),
        np.asarray(jsystem.make_molecules_whole(jsys, jnp.asarray(wrapped))), **E_TOL)
    np.testing.assert_allclose(
        tsystem.compute_virtual_sites(tsys, T(pos)).numpy(),
        np.asarray(jsystem.compute_virtual_sites(jsys, jnp.asarray(pos))), **E_TOL)
    np.testing.assert_array_equal(tsys.masses, jsys.masses)
    np.testing.assert_array_equal(tsys.atom_class, jsys.atom_class)


def test_dms_charges_and_derivatives_vs_jax():
    jsys, tsys, pos = water50_box()
    pw = np.asarray(jsystem.water_positions(jsys, jnp.asarray(pos)))
    q_j, dq_j = jax.jit(jelec.water_charges_and_derivatives)(jnp.asarray(pw))
    q_t, dq_t = telec.water_charges_and_derivatives(T(pw))
    assert dq_t.shape == (50, 3, 3, 3)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), **E_TOL)
    np.testing.assert_allclose(dq_t.numpy(), np.asarray(dq_j), **F_TOL)


def test_thole_scales_and_gammq34_vs_jax():
    rng = np.random.default_rng(2)
    u = rng.uniform(1e-3, 4.0, size=2000)
    th = np.asarray(fixtures_thole())
    for gamma in th:
        sj = jelec.thole_scales(jnp.asarray(u), float(gamma))
        st = telec.thole_scales(T(u), float(gamma))
        for order in (1, 3, 5, 7):
            np.testing.assert_allclose(st[order].numpy(), np.asarray(sj[order]), **E_TOL)
    x = rng.uniform(0.0, 30.0, size=2000)
    np.testing.assert_allclose(tgamma.gammq34(T(x)).numpy(),
                               np.asarray(jgamma.gammq34(jnp.asarray(x))), **E_TOL)


def fixtures_thole():
    from mbpol_openmm_plugin_tpu_torch import _data
    return _data.load('forcefield')['thole']


def test_bspline_vs_jax():
    rng = np.random.default_rng(3)
    w = rng.uniform(0.0, 1.0, size=(64, 3))
    np.testing.assert_allclose(tbs.bspline5(T(w)).numpy(), np.asarray(jbs.bspline5(jnp.asarray(w))),
                               **E_TOL)
    for a, b in zip(tbs.bspline_moduli((27, 25, 24)), jbs.bspline_moduli((27, 25, 24))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('cutoff', [0.47, 0.67])
def test_neighbor_lists_vs_jax_water50(cutoff):
    """Pair and 'complete' triplet lists as sorted sets, plus masks, counts
    and the capacity helpers."""
    jsys, tsys, pos = water50_box()
    o = pos[0::4]
    box = np.asarray([1.8] * 3)
    cap_p = jnb.pair_capacity(50, box, cutoff)
    assert tnb.pair_capacity(50, box, cutoff) == cap_p
    assert tnb.triplet_capacity(50, box, cutoff) == jnb.triplet_capacity(50, box, cutoff)
    assert tnb.max_neighbors(50, box, cutoff) == jnb.max_neighbors(50, box, cutoff)
    pj, mj, nj = jnb.pair_list(jnp.asarray(o), box, cutoff, cap_p)
    pt, mt, nt = tnb.pair_list(T(o), box, cutoff, cap_p)
    assert int(nt) == int(nj) > 0
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    cap_t = jnb.triplet_capacity(50, box, cutoff)
    k_max = jnb.max_neighbors(50, box, cutoff)
    tj, tmj, ntj = jnb.triplet_list(jnp.asarray(o), box, cutoff, cap_t, k_max=k_max)
    tt, tmt, ntt = tnb.triplet_list(T(o), box, cutoff, cap_t, k_max=k_max)
    assert int(ntt) == int(ntj) > 0
    np.testing.assert_array_equal(tmt.numpy(), np.asarray(tmj))

    def as_set(trip, mask):
        return sorted(tuple(sorted(t)) for t in np.asarray(trip)[np.asarray(mask)])
    assert as_set(tt.numpy(), tmt.numpy()) == as_set(tj, tmj)
    # a per-center bound below the real count must surface as overflow
    _, _, n_small = tnb.triplet_list(T(o), box, cutoff, cap_t, k_max=k_max, kt=1)
    assert int(n_small) > cap_t


@pytest.mark.parametrize('switch_width', [0.0, 0.1])
def test_dispersion_pairs_vs_jax_water50(switch_width):
    """The water-pair dispersion (block mode's) against JAX's on the same
    list at cutoff + PAIR_MARGIN, and against the dense port term."""
    jsys, tsys, pos = water50_box()
    pos_v = np.asarray(jsystem.compute_virtual_sites(jsys, jnp.asarray(pos)))
    assert tdisp.PAIR_MARGIN == jdisp.PAIR_MARGIN
    box = np.asarray([1.8] * 3)
    cut = 0.85 + tdisp.PAIR_MARGIN
    cap = tnb.pair_capacity(50, box, cut)
    mp, mask, n = tnb.pair_list(T(pos_v[0::4]), box, cut, cap)
    assert int(n) <= cap
    e_j, g_j = jax.value_and_grad(lambda p: jdisp.dispersion_energy_pairs(
        jsys, p, jnp.asarray(mp.numpy()), jnp.asarray(mask.numpy()), cutoff=0.85,
        switch_width=switch_width))(jnp.asarray(pos_v))
    e_t, g_t = t_grad(lambda p: tdisp.dispersion_energy_pairs(
        tsys, p, mp, mask, cutoff=0.85, switch_width=switch_width), pos_v)
    np.testing.assert_allclose(e_t, float(e_j), **E_TOL)
    np.testing.assert_allclose(g_t, np.asarray(g_j), **F_TOL)
    e_d, _ = t_grad(lambda p: tdisp.dispersion_energy(
        tsys, p, cutoff=0.85, switch_width=switch_width), pos_v)
    np.testing.assert_allclose(e_t, e_d, **E_TOL)


@pytest.mark.parametrize('cutoff', [0.47, 0.67, 1.17])
def test_neighbor_counts_vs_native(cutoff):
    """tune_capacities' exact counts (the port's torch builders) against the
    JAX package's native voxel-hash lists on water256."""
    from mbpol_openmm_plugin_tpu.ops import native
    box = np.asarray([19.3996888399961804 / 10.0] * 3)
    _, pos = fixtures.load_system('water256_integration_test', box=box)
    o = np.asarray(pos)[0::4]
    _, n_p = native.pair_list(o, box, cutoff)
    pairs, _ = native.pair_list(o, box, cutoff, capacity=n_p + 1)
    _, n_t = native.triplet_list(o, box, cutoff)
    trips, _ = native.triplet_list(o, box, cutoff, capacity=n_t + 1)   # untruncated
    n_pt, degree, per_center = tnb.neighbor_counts(T(o), box, cutoff, triplets=True)
    assert n_pt == n_p
    np.testing.assert_array_equal(degree.numpy(), np.bincount(pairs.ravel(), minlength=256))
    assert int(per_center.sum()) == n_t
    np.testing.assert_array_equal(per_center.numpy(), np.bincount(trips[:, 1], minlength=256))


def test_card_gather_backward_on_cpu_tensors():
    """The card's gather (index_select forward, sorted segment_reduce
    backward that leaves masked entries out), run on CPU tensors: exact
    rows, and the gradient of the plain index_add over the unmasked
    entries."""
    from mbpol_openmm_plugin_tpu_torch.ops.gather import _GatherRows
    rng = np.random.default_rng(4)
    table = T(rng.normal(size=(256, 9))).requires_grad_(True)
    idx = torch.as_tensor(rng.integers(0, 250, size=40000))     # rows 250.. unused
    mask = torch.as_tensor(rng.random(40000) < 0.8)
    w = T(rng.normal(size=(40000, 9)))
    for m in (None, mask):
        out = _GatherRows.apply(table, idx, m)
        assert torch.equal(out, table[idx])
        (g,) = torch.autograd.grad((out * w).sum(), table)
        keep = torch.ones_like(mask) if m is None else m
        ref = torch.zeros_like(table).index_add_(0, idx[keep], w[keep])
        np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=1e-12, atol=1e-11)
        assert not g[250:].any()


@pytest.mark.parametrize('term', ['two_body', 'three_body', 'dispersion_pairs'])
def test_card_gather_in_the_terms_on_cpu_tensors(term, monkeypatch):
    """The terms through the card's gather (padded entries left out of the
    backward) give the plain CPU energies and forces on padded lists."""
    from mbpol_openmm_plugin_tpu_torch.ops.gather import _GatherRows
    jsys, tsys, pos = water50_box()
    pos_v = np.asarray(jsystem.compute_virtual_sites(jsys, jnp.asarray(pos)))
    box = np.asarray([1.8] * 3)
    o = T(pos_v[0::4])
    if term == 'three_body':
        lst, mask, n = tnb.triplet_list(o, box, 0.47, tnb.triplet_capacity(50, box, 0.47))
        module, fn = t3b, lambda p: t3b.three_body_energy(tsys, p, lst, mask)
    elif term == 'two_body':
        lst, mask, n = tnb.pair_list(o, box, 0.67, tnb.pair_capacity(50, box, 0.67))
        module, fn = t2b, lambda p: t2b.two_body_energy(tsys, p, lst, mask)
    else:
        lst, mask, n = tnb.pair_list(o, box, 1.1, tnb.pair_capacity(50, box, 1.1))
        module, fn = tdisp, lambda p: tdisp.dispersion_energy_pairs(tsys, p, lst, mask, 0.85)
    assert int(n) < len(mask)                                     # padded entries present
    e_plain, g_plain = t_grad(fn, pos_v)
    monkeypatch.setattr(module, 'gather_rows',
                        lambda table, idx, m=None: _GatherRows.apply(table, idx, m))
    e_card, g_card = t_grad(fn, pos_v)
    assert e_card == e_plain
    np.testing.assert_allclose(g_card, g_plain, rtol=0, atol=1e-10)
