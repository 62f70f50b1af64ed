"""Fused PIP evaluation (energy and dE/dx per row in one launch): four
hand-written CUDA kernels and their plain PyTorch twins (counterpart of
mbpol_openmm_plugin_tpu/ops/pip_pallas.py).

  `pip_energy_grad`               replaces `_kernel` (pip_impl 'pallas'):
      the monomial expansion, mono = exp(sum of log x over a monomial's
      <= 4 factors), e = sum c mono, g = (sum_m e_ma c_m mono_m) / x;
  `pip_quad_energy_grad`          replaces `_quad_kernel` ('quad_pallas'):
      the quadratic form e = m2^T W m2, g = ((2 m2 (m2 W)) @ F) / x with
      the exp/log basis m2 = exp(log xa_i + log xa_j);
  `pip_quad_product_energy_grad`  replaces `_quad_bf16_kernel`
      ('quad_bf16'): the same form with exact products m2 = xa_i * xa_j;
  `pip_vech_energy_grad`          replaces `_vech_kernel` ('vech_pallas'):
      the same form over the natural vech basis (polyeval.load_quad_vech),
      the kernel fed the transposed variables [x, 1]^T [V+1, P]; raises
      for an asymmetric W.

All take `name` ('poly2b' | 'poly3b') and x [P, V] and return (e [P],
g [P, V]). The design of the kernels is in csrc/pip_fused.cu. The TPU
layouts do not come along (no lane padding, no energy column, no padded
copy of x), nor do the bf16 multi-pass products: the kernels are plain
fp32.

Dispatch: a CPU tensor goes to the wrapper's own plain twin (`*_plain`); a
CUDA float32 tensor goes to the kernel; anything else raises. There is no
fallback. The twins repeat the kernels' arithmetic in tensor operations
(the monomial twin in row chunks, so that [P, 33525] stays small) and may
be called by name to compare and time them; nothing on the card's path
calls them. Each wrapper counts its launches in its `launches` attribute.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch.ops import polyeval
from mbpol_openmm_plugin_tpu_torch.ops.elec_direct import _check, _on_kernel, _stream

MONO_SLOTS = 4           # factor slots per monomial (total degree <= 4)
PLAIN_CHUNK = 1024       # rows per chunk of the monomial twin


# ----------------------------------------------------------------------
# Host tables
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def monomial_factors(name):
    """([nmono, 4] uint8 factor list, [nmono] float64 coefficients): each
    monomial as its variable indices in ascending order, an index repeated
    by its exponent, unused slots holding V (log 1 = 0)."""
    pip = polyeval.load_pip(name)
    expo = pip.exponents.astype(np.int64)
    if expo.min() < 0 or expo.sum(axis=1).max() > MONO_SLOTS:
        raise ValueError(f'{name}: a monomial of total degree '
                         f'{int(expo.sum(axis=1).max())} does not fit {MONO_SLOTS} factor slots')
    if pip.nvars >= 255:
        raise ValueError(f'{name}: {pip.nvars} variables do not fit a uint8 factor index')
    factors = np.full((pip.nmono, MONO_SLOTS), pip.nvars, np.uint8)
    for m, row in enumerate(expo):
        idx = np.repeat(np.arange(pip.nvars), row)
        factors[m, :len(idx)] = idx
    return factors, pip.coeffs


@functools.lru_cache(maxsize=None)
def gradient_lists(name):
    """(ptr [V+1], rows) int32: for each variable a, the basis rows k with
    F[k, a] > 0 in ascending order, a row listed F[k, a] times, so that
    (z @ F)[a] = sum of z over rows[ptr[a]:ptr[a+1]]."""
    F, _ = polyeval.load_quad(name)
    rows, ptr = [], [0]
    for a in range(F.shape[1]):
        rows.append(np.repeat(np.arange(F.shape[0]), F[:, a]))
        ptr.append(ptr[-1] + len(rows[-1]))
    return np.asarray(ptr, np.int32), np.concatenate(rows).astype(np.int32)


@functools.lru_cache(maxsize=None)
def vech_w(name):
    """W in the natural vech order; raises for an asymmetric W (the kernel
    computes m2 @ W where the transposed layout means W @ m2, and
    z = 2 m2 (W m2) assumes the same)."""
    _, W = polyeval.load_quad_vech(name)
    if not np.array_equal(W, W.T):
        raise ValueError(f'{name}: the vech kernel requires a symmetric W')
    return W


@functools.lru_cache(maxsize=None)
def _device_tables(name, kind, dtype, device):
    """Device-resident tables of one polynomial: kind 'monomial' (factors
    uint8 [nmono, 4], c), 'quad' (ia, ib int32 [B], W, ptr, rows) or
    'vech' (W_nat,)."""
    def dev(a, dt=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    if kind == 'monomial':
        factors, c = monomial_factors(name)
        return dev(factors), dev(c, dtype)
    if kind == 'quad':
        ia, ib = polyeval._quad_factor_indices(name)
        ptr, rows = gradient_lists(name)
        return (dev(ia, torch.int32), dev(ib, torch.int32),
                dev(polyeval.load_quad(name)[1], dtype), dev(ptr), dev(rows))
    if kind == 'vech':
        return (dev(vech_w(name), dtype),)
    raise ValueError(kind)


# ----------------------------------------------------------------------
# Plain PyTorch twins
# ----------------------------------------------------------------------

def pip_energy_grad_plain(name, x):
    """Plain twin of the monomial kernel: per monomial the sum of its four
    factor logs in slot order, exp, times c; the gradient through the
    dense exponent matrix. Rows in chunks of PLAIN_CHUNK. The sums over
    monomials run in x's dtype (the kernel adds its float32 terms in
    double)."""
    factors, c = _device_tables(name, 'monomial', x.dtype, x.device)
    E, _ = polyeval._pip_tables(name, x.dtype, x.device)
    idx = factors.long()
    e_out, g_out = [], []
    for xc in torch.split(x, PLAIN_CHUNK):
        la = torch.cat([torch.log(xc), torch.zeros_like(xc[:, :1])], dim=1)
        s = ((la[:, idx[:, 0]] + la[:, idx[:, 1]]) + la[:, idx[:, 2]]) + la[:, idx[:, 3]]
        mc = torch.exp(s) * c
        e_out.append(torch.sum(mc, dim=1))
        g_out.append((mc @ E) / xc)
    return torch.cat(e_out), torch.cat(g_out)


def pip_quad_energy_grad_plain(name, x):
    """Plain twin of the exp/log quadratic-form kernel."""
    return polyeval.pip_quad_energy_and_grad(x, name, basis='explog')


def pip_quad_product_energy_grad_plain(name, x):
    """Plain twin of the exact-product quadratic-form kernel."""
    return polyeval.pip_quad_energy_and_grad(x, name, basis='gather')


def pip_vech_energy_grad_plain(name, x):
    """Plain twin of the vech kernel (checks W's symmetry as the kernel's
    wrapper does)."""
    vech_w(name)
    return polyeval.pip_quad_energy_and_grad(x, name, basis='vech')


# ----------------------------------------------------------------------
# Kernel wrappers: CPU -> twin, CUDA float32 -> kernel, else raise
# ----------------------------------------------------------------------

def _check_x(name, x):
    nv = polyeval.load_pip(name).nvars
    if x.dim() != 2 or x.shape[1] != nv:
        raise ValueError(f'{name}: variables must be [P, {nv}], got {tuple(x.shape)}')


def _outputs(x):
    return (torch.empty(x.shape[0], dtype=x.dtype, device=x.device), torch.empty_like(x))


def pip_energy_grad(name, x):
    """Monomial expansion, fused: (e [P], dE/dx [P, V])."""
    _check_x(name, x)
    if not _on_kernel(x):
        return pip_energy_grad_plain(name, x)
    from mbpol_openmm_plugin_tpu_torch.ops import _build
    lib = _build.load()
    factors, c = _device_tables(name, 'monomial', x.dtype, x.device)
    e, g = _outputs(x)
    _check(lib.mbpol_pip_monomial(x.data_ptr(), x.shape[0], x.shape[1], factors.data_ptr(),
                                  c.data_ptr(), c.shape[0], e.data_ptr(), g.data_ptr(),
                                  _stream()), 'pip_energy_grad')
    pip_energy_grad.launches += 1
    return e, g


def _quad_launch(entry, wrapper, name, x):
    from mbpol_openmm_plugin_tpu_torch.ops import _build
    fn = getattr(_build.load(), entry)
    ia, ib, w, ptr, rows = _device_tables(name, 'quad', x.dtype, x.device)
    e, g = _outputs(x)
    _check(fn(x.data_ptr(), x.shape[0], x.shape[1], w.shape[0], ia.data_ptr(), ib.data_ptr(),
              w.data_ptr(), ptr.data_ptr(), rows.data_ptr(), e.data_ptr(), g.data_ptr(),
              _stream()), wrapper.__name__)
    wrapper.launches += 1
    return e, g


def pip_quad_energy_grad(name, x):
    """Quadratic form with the exp/log basis, fused: (e [P], dE/dx [P, V])."""
    _check_x(name, x)
    if not _on_kernel(x):
        return pip_quad_energy_grad_plain(name, x)
    return _quad_launch('mbpol_pip_quad_explog', pip_quad_energy_grad, name, x)


def pip_quad_product_energy_grad(name, x):
    """Quadratic form with the exact-product basis, fused: (e [P],
    dE/dx [P, V])."""
    _check_x(name, x)
    if not _on_kernel(x):
        return pip_quad_product_energy_grad_plain(name, x)
    return _quad_launch('mbpol_pip_quad_product', pip_quad_product_energy_grad, name, x)


def pip_vech_energy_grad(name, x):
    """Quadratic form over the natural vech basis, fused: (e [P],
    dE/dx [P, V]). Raises ValueError for an asymmetric W."""
    _check_x(name, x)
    if not _on_kernel(x):
        return pip_vech_energy_grad_plain(name, x)
    from mbpol_openmm_plugin_tpu_torch.ops import _build
    lib = _build.load()
    (w,) = _device_tables(name, 'vech', x.dtype, x.device)
    xat = polyeval.augmented(x).T.contiguous()            # [V+1, P], batch on the fast axis
    e, g = _outputs(x)
    _check(lib.mbpol_pip_quad_vech(xat.data_ptr(), x.shape[0], x.shape[1], w.shape[0],
                                   w.data_ptr(), e.data_ptr(), g.data_ptr(), _stream()),
           'pip_vech_energy_grad')
    pip_vech_energy_grad.launches += 1
    return e, g


KERNELS = (pip_energy_grad, pip_quad_energy_grad, pip_quad_product_energy_grad,
           pip_vech_energy_grad)
# MBPolConfig.pip_impl value -> wrapper, and each wrapper's twin
WRAPPERS = {'pallas': pip_energy_grad, 'quad_pallas': pip_quad_energy_grad,
            'quad_bf16': pip_quad_product_energy_grad, 'vech_pallas': pip_vech_energy_grad}
PLAIN = {pip_energy_grad: pip_energy_grad_plain,
         pip_quad_energy_grad: pip_quad_energy_grad_plain,
         pip_quad_product_energy_grad: pip_quad_product_energy_grad_plain,
         pip_vech_energy_grad: pip_vech_energy_grad_plain}


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


reset_launch_counts()
