"""Evaluation of the permutationally-invariant polynomials (PIPs): tables,
plain PyTorch evaluators and the dispatch over implementations
(counterpart of mbpol_openmm_plugin_tpu/ops/polyeval.py).

The MB-pol 2B/3B PIPs are degree-4 polynomials in 31/36 positive
variables, held as data in two forms:

  monomial expansion  E(x) = sum_m c_m prod_i x_i^{e_mi}   (`load_pip`:
                      12,725 / 33,525 monomials, <= 4 factors each)
  quadratic form      E(x) = m2(x)^T W m2(x) over the 528 / 703 degree-<=2
                      basis monomials (`load_quad`, tools/factor_pip.py),
                      with the gradient from the same product, dE/dm2 = 2 W m2.

`pip_apply(name, x, impl, basis)` picks the evaluator
(MBPolConfig.pip_impl / pip_basis); each value means what it means in the
JAX package (the lines are those of its ops/polyeval.py):

  impl 'quad' (default)  `pip_quad_energy_and_grad`, plain PyTorch (:330),
                         with the basis built as `basis` says:
      'gather' (default)   exact products xa[ia] * xa[ib] of the augmented
                           variables xa = [x, 1] by index gathers (:320);
      'bf16x3'             the same selection by three bf16 matmuls against
                           one-hot selectors over the exact 3-way bf16
                           split of xa, bit-identical to 'gather' (:239-283);
      'vech'               the structured outer product in the natural
                           vech order with the `load_quad_vech` tables
                           (:188, :230);
  impl 'monomial'        `pip_energy_and_grad`, the monomial expansion
                         through exp(log x @ E^T), plain PyTorch (:89);
  impl 'pallas'          the fused monomial kernel (ops/pip_fused.py
                         `pip_energy_grad`; JAX pip_pallas.py:34);
  impl 'quad_pallas'     the fused quadratic form with the exp/log basis
                         m2 = exp(log x @ F^T) (`pip_quad_energy_grad`;
                         pip_pallas.py:105; the form :355-359 takes for
                         name=None, also here as basis 'explog' of
                         `pip_quad_energy_and_grad`);
  impl 'quad_bf16'       the fused quadratic form with the exact-product
                         basis (`pip_quad_product_energy_grad`; :250);
  impl 'vech_pallas'     the fused quadratic form over the vech basis
                         (`pip_vech_energy_grad`; :317).

The four fused impls run a hand-written CUDA kernel on CUDA float32
tensors and the kernel's plain twin on CPU tensors (ops/pip_fused.py);
`basis` is only read by 'quad'. Arguments are typed: no environment
variable selects anything here. `load_quad_eigen` (numpy tooling of the
JAX package, a recorded negative result) has no caller here and is not
carried over. In eager PyTorch every bf16 cast of the
'bf16x3' split happens as written, so it needs none of the optimisation
barriers the XLA version carries.
"""
import functools

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch import _data

IMPLS = ('quad', 'monomial', 'pallas', 'quad_pallas', 'quad_bf16', 'vech_pallas')
BASES = ('gather', 'bf16x3', 'vech')
FUSED_IMPLS = IMPLS[2:]


class PIPData:
    """One extracted polynomial (exponent matrix + coefficients)."""

    def __init__(self, exponents, coeffs):
        self.exponents = np.asarray(exponents)        # [nmono, nvars] int8
        self.coeffs = np.asarray(coeffs)              # [nmono] float64
        self.nmono, self.nvars = self.exponents.shape


@functools.lru_cache(maxsize=None)
def load_pip(name):
    """name in {'poly2b', 'poly3b'}"""
    d = _data.load(name)
    return PIPData(d['exponents'], d['coeffs'])


@functools.lru_cache(maxsize=None)
def load_quad(name):
    """(F [B, V] int basis exponents, W [B, B] float64) for 'poly2b'/'poly3b'."""
    d = _data.load(name + '_quad')
    return np.asarray(d['basis_exponents']), np.asarray(d['W'])


@functools.lru_cache(maxsize=None)
def _quad_factor_indices(name):
    """(idx_a, idx_b) int64 [B]: m2_k = xa[idx_a_k] * xa[idx_b_k], where
    index V (the appended 1) stands for a missing factor."""
    F, _ = load_quad(name)
    b, v = F.shape
    if F.sum(axis=1).max() > 2:
        raise ValueError(f'{name}: quadratic-form basis has a column of total '
                         'degree > 2; the two-factor decomposition does not apply')
    ia = np.full(b, v, np.int64)
    ib = np.full(b, v, np.int64)
    for k in range(b):
        nz = np.nonzero(F[k])[0]
        if len(nz) == 1:
            ia[k] = nz[0]
            ib[k] = nz[0] if F[k, nz[0]] == 2 else v
        elif len(nz) == 2:
            ia[k], ib[k] = nz
    return ia, ib


@functools.lru_cache(maxsize=None)
def _quad_factor_selectors(name):
    """One-hot factor-selection matrices A, B [V+1, B] float32 with
    m2 = (xa @ A) * (xa @ B): the matrix form of `_quad_factor_indices`."""
    ia, ib = _quad_factor_indices(name)
    b, va = len(ia), load_quad(name)[0].shape[1] + 1
    A = np.zeros((va, b), np.float32)
    B = np.zeros((va, b), np.float32)
    A[ia, np.arange(b)] = 1.0
    B[ib, np.arange(b)] = 1.0
    return A, B


@functools.lru_cache(maxsize=None)
def load_quad_vech(name):
    """The quadratic form re-ordered to the natural vech basis.

    The degree-<=2 product bases are complete: poly2b's 528 columns are
    32*33/2 and poly3b's 703 are 37*38/2, every unordered pair (i <= j) of
    augmented variables xa = [x, 1]. Permuting W and F once into block
    order (i; j = i..Va-1) makes the basis a structured outer product,
    `_vech_basis`. Raises if the basis is not that complete set. Returns
    (F_nat [B, V], W_nat [B, B]), rows/columns permuted consistently (the
    same form, exactly)."""
    F, W = load_quad(name)
    ia, ib = _quad_factor_indices(name)
    lo = np.minimum(ia, ib)
    hi = np.maximum(ia, ib)
    va = F.shape[1] + 1
    b = F.shape[0]
    if b != va * (va + 1) // 2 or len({(int(a), int(c)) for a, c in zip(lo, hi)}) != b:
        raise ValueError(f'{name}: basis is not the complete vech over '
                         f'{va} augmented variables; vech order unavailable')
    order = np.lexsort((hi, lo))
    return F[order], W[np.ix_(order, order)]


@functools.lru_cache(maxsize=None)
def _tables(name, dtype, device, vech=False):
    """Device-resident (F, W, idx_a, idx_b) of the quadratic form, in the
    file order or (vech) the natural vech order."""
    F, W = load_quad_vech(name) if vech else load_quad(name)
    ia, ib = _quad_factor_indices(name)
    return (torch.as_tensor(F, dtype=dtype, device=device),
            torch.as_tensor(W, dtype=dtype, device=device),
            torch.as_tensor(ia, device=device), torch.as_tensor(ib, device=device))


@functools.lru_cache(maxsize=None)
def _pip_tables(name, dtype, device):
    """Device-resident (E [nmono, V], c [nmono]) of the monomial expansion."""
    pip = load_pip(name)
    return (torch.as_tensor(pip.exponents, dtype=dtype, device=device),
            torch.as_tensor(pip.coeffs, dtype=dtype, device=device))


@functools.lru_cache(maxsize=None)
def _selectors_bf16(name, device):
    A, B = _quad_factor_selectors(name)
    return (torch.as_tensor(A, dtype=torch.bfloat16, device=device),
            torch.as_tensor(B, dtype=torch.bfloat16, device=device))


def augmented(x):
    """xa = [x, 1] [..., V+1]."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _vech_basis(xa):
    """Complete degree-<=2 basis in natural vech order from augmented
    variables xa [..., Va]: block i = xa_i * xa_{i:}."""
    va = xa.shape[-1]
    return torch.cat([xa[..., i:i + 1] * xa[..., i:] for i in range(va)], dim=-1)


def _split3_bf16(x):
    """Exact 3-way bf16 decomposition of float32: x == hi + mid + lo (24
    mantissa bits = 3 x 8; no underflow for the PIP variable range)."""
    hi = x.to(torch.bfloat16)
    r1 = x - hi.to(x.dtype)
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.to(x.dtype)).to(torch.bfloat16)
    return hi, mid, lo


def _select_exact_bf16(xa, sel):
    """xa[..., idx] as three bf16 matmuls against the one-hot `sel`
    [Va, B]: every output is one nonzero term per component, so each
    product is exact in bf16 and the float32 sum of the three restores xa
    bit for bit."""
    return sum((part @ sel).to(xa.dtype) for part in _split3_bf16(xa))


def quad_basis(x, name, choice='gather'):
    """Degree-<=2 basis monomials [..., B] of the augmented variables:
    exact products ('gather', 'bf16x3', 'vech': one product rounding, no
    transcendentals) or 'explog', exp(log x_a + log x_b), the form of the
    'quad_pallas' impl. 'vech' returns the natural vech order, which needs
    the `load_quad_vech` tables; the others the file order."""
    if choice == 'explog':
        _, _, ia, ib = _tables(name, x.dtype, x.device)
        la = torch.cat([torch.log(x), torch.zeros_like(x[..., :1])], dim=-1)
        return torch.exp(la[..., ia] + la[..., ib])
    xa = augmented(x)
    if choice == 'vech':
        return _vech_basis(xa)
    if choice == 'bf16x3':
        if x.dtype != torch.float32:
            raise TypeError(f"the 'bf16x3' basis is exact for float32 only, got {x.dtype}")
        A, B = _selectors_bf16(name, x.device)
        return _select_exact_bf16(xa, A) * _select_exact_bf16(xa, B)
    if choice != 'gather':
        raise ValueError(f'unknown PIP basis {choice!r}; expected one of {BASES}')
    _, _, ia, ib = _tables(name, x.dtype, x.device)
    return xa[..., ia] * xa[..., ib]


def quad_form(m2, F, W, x):
    """(e, dE/dx) of the quadratic form from its basis values m2 [P, B]:
    e = sum m2 * (m2 @ W), g = ((2 m2 (m2 @ W)) @ F) / x."""
    wm = m2 @ W
    e = torch.sum(m2 * wm, dim=-1)
    g = ((m2 * (2.0 * wm)) @ F) / x
    return e, g


def pip_quad_energy_and_grad(x, name, basis='gather'):
    """Energy [P] and analytic dE/dx [P, V] of the quadratic-form PIP, with
    the basis built as `basis` says ('gather', 'bf16x3', 'vech', or
    'explog'; see `quad_basis`).

    The W matvec and the gradient contraction run at full fp32 on the card
    (TF32 is off package-wide): the fits' coefficient cancellation loses
    ~46 kcal/mol at water256 with reduced-precision passes, and a
    reduced-precision gradient is white force noise worth +575 K/ns of NVE
    heating (docs/DESIGN.md)."""
    F, W, _, _ = _tables(name, x.dtype, x.device, vech=basis == 'vech')
    return quad_form(quad_basis(x, name, basis), F, W, x)


def pip_energy_and_grad(x, name):
    """Energy and analytic dE/dx of the monomial expansion in one pass
    (three matmuls): mono = exp(log x @ E^T), e = mono @ c,
    g = ((mono * c) @ E) / x. Materializes mono [P, nmono]."""
    E, c = _pip_tables(name, x.dtype, x.device)
    mono = torch.exp(torch.log(x) @ E.T)
    e = mono @ c
    g = ((mono * c) @ E) / x
    return e, g


def _pip_impl_choice(impl=None, basis=None):
    """(impl, basis) with None resolved to the defaults ('quad', 'gather');
    raises ValueError for a value outside IMPLS / BASES. Nothing falls back
    to another impl: on CPU tensors a fused impl evaluates its own plain
    twin (ops/pip_fused.py)."""
    impl = 'quad' if impl is None else impl
    basis = 'gather' if basis is None else basis
    if impl not in IMPLS:
        raise ValueError(f'unknown pip_impl {impl!r}; expected one of {IMPLS}')
    if basis not in BASES:
        raise ValueError(f'unknown pip_basis {basis!r}; expected one of {BASES}')
    return impl, basis


def pip_energy_grad_by(impl, basis, name, x):
    """(e [P], dE/dx [P, V]) by the resolved impl (one of IMPLS)."""
    if impl == 'quad':
        return pip_quad_energy_and_grad(x, name, basis)
    if impl == 'monomial':
        return pip_energy_and_grad(x, name)
    from mbpol_openmm_plugin_tpu_torch.ops import pip_fused
    return pip_fused.WRAPPERS[impl](name, x)


class _PipApply(torch.autograd.Function):
    """E(x) whose backward is the analytic gradient the forward returned
    (the counterpart of the JAX package's custom_jvp around pip_apply;
    reverse mode only)."""

    @staticmethod
    def forward(ctx, x, name, impl, basis):
        e, g = pip_energy_grad_by(impl, basis, name, x)
        ctx.save_for_backward(g)
        return e

    @staticmethod
    def backward(ctx, grad_e):
        (g,) = ctx.saved_tensors
        return grad_e[:, None] * g, None, None, None


def pip_apply(name, x, impl=None, basis=None):
    """Batched PIP energies [P] of variables x [P, V]; differentiable once.
    `impl`/`basis` are MBPolConfig.pip_impl/pip_basis (None: 'quad' with
    the 'gather' basis)."""
    impl, basis = _pip_impl_choice(impl, basis)
    return _PipApply.apply(x, name, impl, basis)
