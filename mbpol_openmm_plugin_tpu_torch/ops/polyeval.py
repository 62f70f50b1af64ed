"""Quadratic-form evaluation of the permutationally-invariant polynomials
(port of the `quad` impl with the `gather` basis in
mbpol_openmm_plugin_tpu/ops/polyeval.py).

The MB-pol 2B/3B PIPs are degree-4 polynomials in 31/36 positive
variables. tools/factor_pip.py factors each into a quadratic form over the
degree-<=2 monomial basis: E(x) = m2(x)^T W m2(x), with every basis
monomial an exact product of two augmented variables xa = [x, 1]. The
gradient reuses the W matvec: dE/dm2 = 2 W m2.

Not ported (recorded negative results or TPU-only): the `bf16x3` and
`vech` bases, `load_quad_eigen`, the monomial expansion and the Pallas
impls (see ROADMAP.md).
"""
import functools

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch import _data


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
def _tables(name, dtype, device):
    """Device-resident (F, W, idx_a, idx_b) for one polynomial."""
    F, W = load_quad(name)
    ia, ib = _quad_factor_indices(name)
    return (torch.as_tensor(F, dtype=dtype, device=device),
            torch.as_tensor(W, dtype=dtype, device=device),
            torch.as_tensor(ia, device=device), torch.as_tensor(ib, device=device))


def quad_basis(x, name):
    """Degree-<=2 basis monomials [..., B] by exact products of the augmented
    variables (one product rounding, no transcendentals)."""
    _, _, ia, ib = _tables(name, x.dtype, x.device)
    xa = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
    return xa[..., ia] * xa[..., ib]


def pip_quad_energy_and_grad(x, name):
    """Energy [P] and analytic dE/dx [P, V] of the quadratic-form PIP.

    The W matvec and the gradient contraction run at full fp32 on the card
    (TF32 is off package-wide): the fits' coefficient cancellation loses
    ~46 kcal/mol at water256 with reduced-precision passes, and a
    reduced-precision gradient is white force noise worth +575 K/ns of NVE
    heating (docs/DESIGN.md)."""
    F, W, _, _ = _tables(name, x.dtype, x.device)
    m2 = quad_basis(x, name)
    wm = m2 @ W
    e = torch.sum(m2 * wm, dim=-1)
    g = ((m2 * (2.0 * wm)) @ F) / x
    return e, g


class _PipApply(torch.autograd.Function):
    """E(x) whose backward is the analytic gradient the forward returned
    (the counterpart of the JAX package's custom_jvp around pip_apply)."""

    @staticmethod
    def forward(ctx, x, name):
        e, g = pip_quad_energy_and_grad(x, name)
        ctx.save_for_backward(g)
        return e

    @staticmethod
    def backward(ctx, grad_e):
        (g,) = ctx.saved_tensors
        return grad_e[:, None] * g, None


def pip_apply(name, x):
    """Batched PIP energies [P] of variables x [P, V]; differentiable once."""
    return _PipApply.apply(x, name)
