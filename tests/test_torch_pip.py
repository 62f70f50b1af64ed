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
      1e-6 kJ/mol per term, 1e-6 kJ/mol/nm on forces;
  (e) the bf16 x 6 split product of the two tensor-core kernels' twins:
      against the JAX package's `_dot6` on the same operands at 1e-6 of
      max |m2 W| (the same 36 bf16 x bf16 products per output, summed in
      float32 in another order); the float32 twins against the Pallas
      kernels in interpret mode at 2e-5 as in (b); on the water256
      fixture's variables, no further from float64 than ACC_FACTOR = 2
      times the plain float32 evaluator; the 3-way split exact bit for bit;
      the kernels' host tables (tiled split W, tiled F) against the dense
      ones, exactly.
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
    the monomial factor list rebuilds the exponent matrix; the vech kernel's
    closed-form index of basis row (i, j) sums to z @ F_nat; the selectors
    match the indices."""
    pip = polyeval.load_pip(name)
    factors, c = pip_fused.monomial_factors(name)
    expo = np.zeros((pip.nmono, pip.nvars + 1), np.int64)
    np.add.at(expo, (np.arange(pip.nmono)[:, None], factors.astype(np.int64)), 1)
    np.testing.assert_array_equal(expo[:, :pip.nvars], pip.exponents)
    np.testing.assert_array_equal(c, pip.coeffs)

    Fn, _ = polyeval.load_quad_vech(name)
    z = np.random.default_rng(5).normal(size=Fn.shape[0])
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


# ---- (e) the bf16 x 6 split product of the tensor-core kernels

SPLIT_TWINS = {'quad_pallas': (pip_fused.pip_quad_energy_grad_plain, 'explog'),
               'quad_bf16': (pip_fused.pip_quad_product_energy_grad_plain, 'gather')}


@pytest.mark.parametrize('name', POLYS)
def test_split_product_matches_jax_dot6(name):
    """`split_product` against the JAX kernels' `_dot6` over their own
    3-way splits of the same m2 and W."""
    x = torch.as_tensor(variables(name, np.float32))
    m2 = polyeval.quad_basis(x, name)
    _, W = polyeval.load_quad(name)
    ws = pip_fused.split_w(W)
    jw = jnp.asarray(W, jnp.float32)
    jws = jpallas._split3(jw)
    for t, j in zip(ws, jws):                      # the splits themselves agree bit for bit
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j.astype(jnp.float32)))
    want = np.asarray(jpallas._dot6(jpallas._split3(jnp.asarray(m2.numpy())), jws))
    got = pip_fused.split_product(m2, [w.float() for w in ws]).numpy()
    assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))
    plain = (m2.double() @ torch.as_tensor(W)).numpy()
    assert np.max(np.abs(got - plain)) <= 1e-6 * np.max(np.abs(plain))


@pytest.mark.parametrize('name', POLYS)
@pytest.mark.parametrize('impl', sorted(SPLIT_TWINS))
def test_split_twin_matches_pallas_interpret(impl, name, monkeypatch):
    """The split-product float32 twin, called by name, against the Pallas
    kernel it mirrors in interpret mode: 2e-5 of the max, as in (b)."""
    x = variables(name, np.float32)
    if impl == 'quad_bf16':
        want = jpallas.pip_quad_bf16_energy_grad_tpu(name, jnp.asarray(x), interpret=True)
    else:
        monkeypatch.setattr(jpallas.pl, 'pallas_call',
                            functools.partial(pl.pallas_call, interpret=True))
        want = jpallas.pip_quad_energy_grad_tpu(name, jnp.asarray(x))
    twin, basis = SPLIT_TWINS[impl]
    got = twin(name, torch.as_tensor(x))
    assert got[0].dtype == torch.float32
    assert_close(got, want, 2e-5)
    # float64 variables take the plain product
    x64 = torch.as_tensor(x).double()
    assert_close(twin(name, x64), polyeval.pip_quad_energy_and_grad(x64, name, basis=basis), 0.0)


@pytest.fixture(scope='module')
def water256_variables():
    from mbpol_openmm_plugin_tpu_torch.tools.pip_split_accuracy import water256_variables
    return water256_variables(torch.device('cpu'))


@pytest.mark.parametrize('name', POLYS)
@pytest.mark.parametrize('impl', sorted(SPLIT_TWINS))
def test_split_twin_is_as_accurate_as_float32_on_a_water_box(impl, name, water256_variables):
    """The choice of the arithmetic, as a test: on the variables the
    water256 lists give the polynomial (the first 8192 rows), where the
    fits cancel over three orders of magnitude, the split twin's error
    against float64 is at most ACC_FACTOR times the plain float32
    evaluator's, for e and for g."""
    x = water256_variables[name][:8192]
    twin, basis = SPLIT_TWINS[impl]
    ref = polyeval.pip_quad_energy_and_grad(x.double(), name, basis=basis)
    plain = polyeval.pip_quad_energy_and_grad(x, name, basis=basis)
    got = twin(name, x)
    for g, f32, r in zip(got, plain, ref):
        err, err32 = float((g.double() - r).abs().max()), float((f32.double() - r).abs().max())
        assert err32 > 0.0
        assert err <= pip_fused_check.ACC_FACTOR * err32, (err, err32)


@pytest.mark.parametrize('name', POLYS)
def test_split3_round_trips_bit_for_bit(name):
    """hi + mid + lo == x exactly, for basis values and for W; each part is
    a bf16 value."""
    x = torch.as_tensor(variables(name, np.float32))
    w32 = torch.as_tensor(polyeval.load_quad(name)[1], dtype=torch.float32)
    for v in (polyeval.quad_basis(x, name), polyeval.quad_basis(x, name, 'explog'), w32):
        hi, mid, lo = polyeval._split3_bf16(v)
        assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
        assert torch.equal((hi.float() + mid.float()) + lo.float(), v)
    assert all(torch.equal(a, b) for a, b in zip(pip_fused.split_w(w32.numpy()),
                                                 polyeval._split3_bf16(w32)))


@pytest.mark.parametrize('name', POLYS)
def test_quad_kernel_tables_hold_the_polynomial(name):
    """The tables the tensor-core kernels read, against the dense ones: the
    packed factor indices; the tiled 3-way split of W, which sums back to
    float32(W) bit for bit with zero padding; the tiled F, exactly."""
    F, W = polyeval.load_quad(name)
    ia, ib = polyeval._quad_factor_indices(name)
    b, v = F.shape
    idx, wtiles, ftiles = pip_fused.quad_kernel_tables(name)
    bp = len(idx)
    assert bp % pip_fused.N_CHUNK == 0 and bp % pip_fused.K_TILE == 0 and b <= bp < b + 176
    np.testing.assert_array_equal(idx[:b] & 0xff, ia)
    np.testing.assert_array_equal(idx[:b] >> 8, ib)
    assert np.all(idx[b:] == (v | v << 8))

    # [chunk][tile][part][column group][row half][column][row] -> [part][row][column]
    assert wtiles.dtype == torch.bfloat16 and wtiles.is_contiguous()
    assert tuple(wtiles.shape) == (bp // 176, bp // 16, 3, 22, 2, 8, 8)
    parts = wtiles.float().permute(2, 1, 4, 6, 0, 3, 5).reshape(3, bp, bp)
    Wp = np.zeros((bp, bp), np.float32)
    Wp[:b, :b] = W
    np.testing.assert_array_equal(((parts[0] + parts[1]) + parts[2]).numpy(), Wp)
    # one tile of the stream, element by element: chunk 1, tile 2, part 0
    w1 = pip_fused.split_w(Wp)[0].float().numpy()
    tile = wtiles[1, 2, 0].float().numpy()            # [22, 2, 8 columns, 8 rows]
    for j, h, r, c in ((0, 0, 0, 0), (3, 1, 2, 5), (21, 1, 7, 7)):
        assert tile[j, h, r, c] == w1[2 * 16 + 8 * h + c, 176 + 8 * j + r]

    # [chunk][tile][variable group][row half][variable][row] -> [row][variable]
    assert ftiles.dtype == torch.bfloat16 and ftiles.is_contiguous()
    assert tuple(ftiles.shape) == (bp // 176, 11, pip_fused.V_PAD // 8, 2, 8, 8)
    Fp = np.zeros((bp, pip_fused.V_PAD), np.float32)
    Fp[:b, :v] = F
    np.testing.assert_array_equal(
        ftiles.float().permute(0, 1, 3, 5, 2, 4).reshape(bp, pip_fused.V_PAD).numpy(), Fp)
    tile = ftiles[1, 3].float().numpy()               # rows 176 + 48 .. + 64
    for j, h, r, c in ((0, 0, 0, 0), (2, 1, 3, 6), (4, 1, 7, 7)):
        assert tile[j, h, r, c] == Fp[176 + 48 + 8 * h + c, 8 * j + r]


def test_quad_launch_shape():
    assert pip_fused.quad_launch_shape(1, 132) == (1, 1 / 264)
    assert pip_fused.quad_launch_shape(64, 132)[0] == 1
    assert pip_fused.quad_launch_shape(65, 132)[0] == 2
    blocks, waves = pip_fused.quad_launch_shape(8545, 132)      # the water256 pair batch
    assert blocks == 134 and waves < 1.0
    blocks, waves = pip_fused.quad_launch_shape(40448, 132)     # the triplet batch
    assert blocks == 632 and 2.0 < waves < 3.0


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
