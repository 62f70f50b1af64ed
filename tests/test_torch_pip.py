"""The port's PIP evaluators (ops/polyeval.py, ops/pip_fused.py) against
the JAX package, on the CPU.

Inputs: 300 rows per polynomial, uniform in [1e-4, 1] from numpy's
default_rng (the PIP variables' physical range), and the water50 fixture
for the whole potential. Bounds:
  (a) each float64 twin / plain evaluator against the JAX plain function
      of the same formula: 1e-10 of the batch's max |e| and max |g|;
  (b) each float32 twin against the Pallas kernel it mirrors, run in
      interpret mode: 2e-5 of the max (the Pallas bodies and the twins sum
      in different orders, and the fits cancel over three orders of
      magnitude; measured differences are <= 2e-6 of the max);
  (c) the 'bf16x3' basis bit-identical to 'gather' in float32, the 'vech'
      order against 'gather' at 1e-12;
  (d) MBPol(device='cpu') under each pip_impl against the JAX MBPol with
      the same value (which evaluates 'quad' or 'monomial' on the CPU):
      1e-6 kJ/mol per term, 1e-6 kJ/mol/nm on forces.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import fixtures
from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
from mbpol_openmm_plugin_tpu.ops import pip_pallas as jpallas
from mbpol_openmm_plugin_tpu.ops import polyeval as jpoly
from mbpol_openmm_plugin_tpu_torch import convert
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.ops import pip_fused, pip_fused_check, polyeval
from mbpol_openmm_plugin_tpu_torch.system import System
from test_torch_potential import TERMS, jax_arrays

torch.set_num_threads(1)

POLYS = ('poly2b', 'poly3b')
N_ROWS = 300
FUSED = dict(zip(polyeval.FUSED_IMPLS, pip_fused.KERNELS))


def variables(name, dtype=np.float64, n=N_ROWS):
    nv = polyeval.load_pip(name).nvars
    seed = POLYS.index(name)
    return np.random.default_rng(seed).uniform(1e-4, 1.0, (n, nv)).astype(dtype)


def assert_close(got, want, rel):
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        assert np.max(np.abs(g - w)) <= rel * np.max(np.abs(w)), \
            (np.max(np.abs(g - w)), np.max(np.abs(w)))


def jax_plain(kind, name, x):
    """The JAX package's plain function of the formula `kind`."""
    x = jnp.asarray(x)
    if kind == 'monomial':
        pip = jpoly.load_pip(name)
        return jpoly.pip_energy_and_grad(x, jnp.asarray(pip.exponents), jnp.asarray(pip.coeffs))
    F, W = jpoly.load_quad_vech(name) if kind == 'vech' else jpoly.load_quad(name)
    if kind == 'explog':
        return jpoly.pip_quad_energy_and_grad(x, jnp.asarray(F), jnp.asarray(W), name=None)
    return jpoly.pip_quad_energy_and_grad(x, jnp.asarray(F), jnp.asarray(W), name=name,
                                          basis=kind)


# ---- (a) float64 twins and plain evaluators against the JAX plain functions

@pytest.mark.parametrize('name', POLYS)
@pytest.mark.parametrize('impl,kind', [('pallas', 'monomial'), ('quad_pallas', 'explog'),
                                       ('quad_bf16', 'gather'), ('vech_pallas', 'vech')])
def test_float64_twin_matches_jax_plain(impl, kind, name):
    x = variables(name)
    want = jax_plain(kind, name, x)
    wrapper = FUSED[impl]
    before = wrapper.launches
    assert_close(wrapper(name, torch.as_tensor(x)), want, 1e-10)       # CPU tensor -> twin
    assert_close(pip_fused.PLAIN[wrapper](name, torch.as_tensor(x)), want, 1e-10)
    assert wrapper.launches == before                                    # nothing was launched


@pytest.mark.parametrize('name', POLYS)
def test_plain_evaluators_match_jax(name):
    x = variables(name)
    tx = torch.as_tensor(x)
    assert_close(polyeval.pip_energy_and_grad(tx, name), jax_plain('monomial', name, x), 1e-10)
    for basis in ('gather', 'vech', 'explog'):
        assert_close(polyeval.pip_quad_energy_and_grad(tx, name, basis=basis),
                     jax_plain(basis, name, x), 1e-10)
    # all forms are one polynomial
    assert_close(polyeval.pip_energy_and_grad(tx, name), jax_plain('gather', name, x), 1e-9)


# ---- (b) float32 twins against the Pallas kernels in interpret mode

@pytest.mark.parametrize('name', POLYS)
@pytest.mark.parametrize('impl', polyeval.FUSED_IMPLS)
def test_float32_twin_matches_pallas_interpret(impl, name, monkeypatch):
    x = variables(name, np.float32)
    jx = jnp.asarray(x)
    if impl == 'quad_bf16':
        want = jpallas.pip_quad_bf16_energy_grad_tpu(name, jx, interpret=True)
    elif impl == 'vech_pallas':
        want = jpallas.pip_vech_energy_grad_tpu(name, jx, interpret=True)
    else:
        # these two wrappers take no interpret argument
        monkeypatch.setattr(jpallas.pl, 'pallas_call',
                            functools.partial(pl.pallas_call, interpret=True))
        fn = jpallas.pip_energy_grad_tpu if impl == 'pallas' else jpallas.pip_quad_energy_grad_tpu
        want = fn(name, jx)
    got = FUSED[impl](name, torch.as_tensor(x))
    assert got[0].dtype == torch.float32
    assert_close(got, want, 2e-5)


# ---- (c) the bases

@pytest.mark.parametrize('name', POLYS)
def test_bf16x3_basis_is_bit_identical_to_gather(name):
    x = torch.as_tensor(variables(name, np.float32))
    assert torch.equal(polyeval.quad_basis(x, name, 'bf16x3'), polyeval.quad_basis(x, name))
    e0, g0 = polyeval.pip_quad_energy_and_grad(x, name)
    e1, g1 = polyeval.pip_quad_energy_and_grad(x, name, basis='bf16x3')
    assert torch.equal(e0, e1) and torch.equal(g0, g1)
    with pytest.raises(TypeError):
        polyeval.quad_basis(x.double(), name, 'bf16x3')


@pytest.mark.parametrize('name', POLYS)
def test_vech_order_matches_gather(name):
    x = torch.as_tensor(variables(name))
    e0, g0 = polyeval.pip_quad_energy_and_grad(x, name)
    e1, g1 = polyeval.pip_quad_energy_and_grad(x, name, basis='vech')
    sc = float(e0.abs().max())
    assert float((e1 - e0).abs().max()) < 1e-12 * sc
    assert float((g1 - g0).abs().max()) < 1e-11 * sc
    Fj, Wj = jpoly.load_quad_vech(name)
    Ft, Wt = polyeval.load_quad_vech(name)
    np.testing.assert_array_equal(Ft, Fj)
    np.testing.assert_array_equal(Wt, Wj)


@pytest.mark.parametrize('name', POLYS)
def test_kernel_tables_hold_the_polynomial(name):
    """The compact tables the CUDA kernels read, against the dense ones:
    the monomial factor list rebuilds the exponent matrix; the per-variable
    gradient lists sum to z @ F; the vech kernel's closed-form index of
    basis row (i, j) sums to z @ F_nat; the selectors match the indices."""
    pip = polyeval.load_pip(name)
    factors, c = pip_fused.monomial_factors(name)
    expo = np.zeros((pip.nmono, pip.nvars + 1), np.int64)
    np.add.at(expo, (np.arange(pip.nmono)[:, None], factors.astype(np.int64)), 1)
    np.testing.assert_array_equal(expo[:, :pip.nvars], pip.exponents)
    np.testing.assert_array_equal(c, pip.coeffs)

    F, _ = polyeval.load_quad(name)
    z = np.random.default_rng(5).normal(size=F.shape[0])
    ptr, rows = pip_fused.gradient_lists(name)
    np.testing.assert_allclose([z[rows[ptr[a]:ptr[a + 1]]].sum() for a in range(F.shape[1])],
                               z @ F, rtol=1e-12, atol=1e-12)

    Fn, _ = polyeval.load_quad_vech(name)
    va = Fn.shape[1] + 1

    def row(i, j):
        lo, hi = min(i, j), max(i, j)
        return lo * va - lo * (lo - 1) // 2 + hi - lo
    got = [sum(z[row(a, j)] * (2 if j == a else 1) for j in range(va)) for a in range(va - 1)]
    np.testing.assert_allclose(got, z @ Fn, rtol=1e-12, atol=1e-12)

    A, B = polyeval._quad_factor_selectors(name)
    Aj, Bj = jpoly._quad_factor_selectors(name)
    np.testing.assert_array_equal(A, Aj)
    np.testing.assert_array_equal(B, Bj)


def test_vech_wrapper_refuses_an_asymmetric_w(monkeypatch):
    F, W = polyeval.load_quad_vech('poly2b')
    W = W.copy()
    W[0, 1] += 1.0
    monkeypatch.setattr(polyeval, 'load_quad_vech', lambda name: (F, W))
    pip_fused.vech_w.cache_clear()
    try:
        with pytest.raises(ValueError, match='symmetric'):
            pip_fused.pip_vech_energy_grad('poly2b', torch.as_tensor(variables('poly2b')))
    finally:
        pip_fused.vech_w.cache_clear()


# ---- the autograd Function and its dispatch

@pytest.mark.parametrize('impl,basis', [(None, None), ('quad', 'bf16x3'), ('quad', 'vech'),
                                        ('monomial', None)]
                         + [(i, None) for i in polyeval.FUSED_IMPLS])
def test_pip_apply_gradient(impl, basis):
    """Every impl is the same polynomial, and the Function's backward (the
    analytic gradient) agrees with finite differences."""
    dtype = np.float32 if basis == 'bf16x3' else np.float64
    x = torch.as_tensor(variables('poly2b', dtype, n=4))
    ref = polyeval.pip_quad_energy_and_grad(x.double(), 'poly2b')
    xg = x.clone().requires_grad_(True)
    e = polyeval.pip_apply('poly2b', xg, impl=impl, basis=basis)
    (g,) = torch.autograd.grad(e, xg, torch.ones_like(e))
    assert_close((e.detach(), g), ref, 1e-4 if dtype == np.float32 else 1e-9)
    if dtype == np.float64:
        # away from the cancelling small-x corner, where central differences resolve
        xs = torch.as_tensor(np.random.default_rng(9).uniform(0.3, 1.0, (3, x.shape[1])))
        assert torch.autograd.gradcheck(
            lambda v: polyeval.pip_apply('poly2b', v, impl=impl, basis=basis),
            xs.requires_grad_(True), eps=1e-6, atol=1e-4, rtol=1e-5)


def test_unknown_impl_or_basis_raises():
    x = torch.as_tensor(variables('poly2b', n=2))
    with pytest.raises(ValueError, match='pip_impl'):
        polyeval.pip_apply('poly2b', x, impl='quad_mxu')
    with pytest.raises(ValueError, match='pip_basis'):
        polyeval.pip_apply('poly2b', x, basis='explog')      # not a config value
    sys_ = System.waters(3, box=[1.9] * 3)
    with pytest.raises(ValueError, match='pip_impl'):
        MBPol(sys_, MBPolConfig(nonbonded_method='PME', pip_impl='fused'), device='cpu')
    with pytest.raises(ValueError, match='pip_basis'):
        MBPol(sys_, MBPolConfig(nonbonded_method='PME', pip_basis='lanes'), device='cpu')
    with pytest.raises(ValueError, match=r'\[P, 31\]'):
        pip_fused.pip_energy_grad('poly2b', x[:, :30])


# ---- the kernel check itself

@pytest.mark.parametrize('name', POLYS)
def test_kernel_check_catches_a_one_percent_error(name):
    """pip_fused_check on CPU tensors (wrapper = twin) passes, and fails for
    a 1% error in one row's energy or in one gradient entry."""
    x = torch.as_tensor(variables(name, np.float32))
    wrapper = pip_fused.pip_quad_product_energy_grad
    rows, max_abs = pip_fused_check.kernel_rows(wrapper, name, x)
    assert all(r.ok for r in rows) and max_abs == 0.0
    e, g = wrapper(name, x)
    e64, g64 = wrapper(name, x.double())
    # an entry of middling size: above 0.2% of the largest
    i = int(torch.argsort(e.abs())[len(e) // 2])
    assert e[i].abs() > 0.002 * e.abs().max()
    e_bad = e.clone()
    e_bad[i] *= 1.01
    failed = [r for r in pip_fused_check.pip_rows((e_bad, g), (e, g), (e64, g64)) if not r.ok]
    assert {(r.output, r.measure) for r in failed} >= {('e', 'rel')}
    j = int(torch.argsort(g.abs().reshape(-1))[g.numel() - g.numel() // 50])
    assert g.reshape(-1)[j].abs() > 0.002 * g.abs().max()
    g_bad = g.clone()
    g_bad.reshape(-1)[j] *= 1.01
    failed = [r for r in pip_fused_check.pip_rows((e, g_bad), (e, g), (e64, g64)) if not r.ok]
    assert {(r.output, r.measure) for r in failed} >= {('g', 'rel')}
    g_nan = g.clone()
    g_nan[0, 0] = float('nan')
    assert any(not r.ok for r in pip_fused_check.pip_rows((e, g_nan), (e, g), (e64, g64)))


# ---- (d) the whole potential under each impl

@pytest.fixture(scope='module')
def water50():
    box = [1.8] * 3
    jsys, pos = fixtures.load_system('water50', box=box)
    d = fixtures.load('water50')
    return jsys, System.from_atom_names(d['names'], d['resnames'], box=box), pos


@pytest.mark.parametrize('impl,basis', [('monomial', None), ('quad', 'vech')]
                         + [(i, None) for i in polyeval.FUSED_IMPLS])
def test_potential_under_pip_impl_matches_jax(water50, impl, basis):
    jsys, tsys, pos = water50
    cfg = dict(nonbonded_method='PME', cutoff=0.9, pip_impl=impl, pip_basis=basis)
    jpot = JMBPol(jsys, JConfig(**cfg))
    ej, fj, pj, _ = jpot.energy_forces(pos)
    # the config, pip fields included, carries across with the arrays
    tpot = convert.from_jax_arrays(tsys, MBPolConfig(**cfg), device='cpu', **jax_arrays(jpot))
    assert (tpot.config.pip_impl, tpot.config.pip_basis) == (impl, basis)
    before = [k.launches for k in pip_fused.KERNELS]
    et, ft, pt, _ = tpot.energy_forces(np.array(pos))
    assert [k.launches for k in pip_fused.KERNELS] == before
    for k in TERMS:
        assert abs(float(pt[k]) - float(pj[k])) <= 1e-6, (k, float(pt[k]), float(pj[k]))
    assert abs(float(et) - float(ej)) <= 1e-6
    assert np.max(np.abs(ft.numpy() - np.asarray(fj))) <= 1e-6
