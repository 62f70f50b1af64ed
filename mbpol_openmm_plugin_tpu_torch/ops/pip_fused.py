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
copy of x). The monomial and vech kernels are plain fp32 on the CUDA
cores. The exp/log and exact-product kernels run the product m2 @ W on
the tensor cores as the six highest cross products of exact 3-way bf16
splits of m2 and W, summed in float32 (`split_product`, the scheme of the
JAX kernels' `_dot6`), and the gradient contraction z @ F as three exact
bf16 passes over the split of z (their `_dot3`); W's splits and F are laid
out once on the host in the tiles the kernel streams (`quad_kernel_tables`).

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
# Tiling of the tensor-core quadratic-form kernels (csrc/pip_fused.cu): W
# streams in tiles of K_TILE basis rows x N_CHUNK output columns; F, for the
# gradient z @ F, in tiles of K_TILE basis rows x V_PAD variables.
K_TILE, N_CHUNK, V_PAD = 16, 176, 40


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
def vech_w(name):
    """W in the natural vech order; raises for an asymmetric W (the kernel
    computes m2 @ W where the transposed layout means W @ m2, and
    z = 2 m2 (W m2) assumes the same)."""
    _, W = polyeval.load_quad_vech(name)
    if not np.array_equal(W, W.T):
        raise ValueError(f'{name}: the vech kernel requires a symmetric W')
    return W


def split_w(W):
    """The exact 3-way bf16 split of float32(W): (w1, w2, w3) bfloat16 with
    w1 + w2 + w3 == float32(W) bit for bit."""
    return polyeval._split3_bf16(torch.as_tensor(np.asarray(W), dtype=torch.float32))


def _core_tiles(m, n_group):
    """A [K, N] bfloat16 B operand in the K-major core-matrix layout of
    `wgmma`, N in groups of n_group columns: [N group][K tile of K_TILE]
    [group of 8 columns][half of 8 rows][column][row], the [8 columns]
    [8 rows] blocks (128 bytes) being the core matrices."""
    k, n = m.shape
    tiles = m.reshape(k // K_TILE, 2, 8, n // n_group, n_group // 8, 8)
    return tiles.permute(3, 0, 4, 1, 5, 2)


@functools.lru_cache(maxsize=None)
def quad_kernel_tables(name):
    """Host tables of the tensor-core quadratic-form kernels:

      idx [Bp] uint16 (numpy)
            factor indices ia | ib << 8 of basis row k (m2_k = xa[ia] *
            xa[ib]); rows B..Bp, the padding to a multiple of N_CHUNK, hold
            V | V << 8 (1 * 1);
      wtiles bfloat16 [Bp / N_CHUNK, Bp / K_TILE, 3, N_CHUNK / 8, 2, 8, 8]
            W padded with zeros to [Bp, Bp], split 3 ways (`split_w`) and cut
            into the tiles the kernel streams, in streaming order: [chunk of
            N_CHUNK columns][tile of K_TILE rows][part], each part of a tile
            in the layout of `_core_tiles`;
      ftiles bfloat16 [Bp / N_CHUNK, N_CHUNK / K_TILE, V_PAD / 8, 2, 8, 8]
            F (entries 0, 1, 2: exact in bfloat16) padded with zeros to
            [Bp, V_PAD], its rows cut by chunk and K_TILE: [chunk][tile]
            then the layout of `_core_tiles`, for the gradient z @ F."""
    F, W = polyeval.load_quad(name)
    ia, ib = polyeval._quad_factor_indices(name)
    b, v = F.shape
    bp = -(-b // N_CHUNK) * N_CHUNK
    if v > V_PAD or F.max() > 2:
        raise ValueError(f'{name}: {v} variables / basis exponent {F.max()} do not fit the '
                         'kernel tables')
    idx = np.full(bp, v | v << 8, np.uint16)
    idx[:b] = ia | ib << 8
    Wp = np.zeros((bp, bp), np.float32)
    Wp[:b, :b] = W
    wtiles = torch.stack([_core_tiles(part, N_CHUNK) for part in split_w(Wp)], dim=2)
    Fp = torch.zeros(bp, V_PAD, dtype=torch.bfloat16)
    Fp[:b, :v] = torch.as_tensor(F, dtype=torch.bfloat16)
    ftiles = _core_tiles(Fp, V_PAD)[0].reshape(bp // N_CHUNK, N_CHUNK // K_TILE, V_PAD // 8,
                                               2, 8, 8)
    return idx, wtiles.contiguous(), ftiles.contiguous()


@functools.lru_cache(maxsize=None)
def _device_tables(name, kind, dtype, device):
    """Device-resident tables of one polynomial: kind 'monomial' (factors
    uint8 [nmono, 4], c), 'quad' (the kernel tables of `quad_kernel_tables`,
    idx as int16 bits), 'split' (F and the three splits of W as
    `dtype`, for the twins) or 'vech' (W_nat,)."""
    def dev(a, dt=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    if kind == 'monomial':
        factors, c = monomial_factors(name)
        return dev(factors), dev(c, dtype)
    if kind == 'quad':
        idx, wtiles, ftiles = quad_kernel_tables(name)
        return dev(idx.view(np.int16)), wtiles.to(device), ftiles.to(device)
    if kind == 'split':
        F, W = polyeval.load_quad(name)
        return dev(F, dtype), tuple(w.to(device=device, dtype=dtype) for w in split_w(W))
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


def split_product(m2, ws):
    """m2 @ W in float32 from bf16 operands, as the tensor-core kernels
    compute it: m2 [P, B] float32 is split exactly into three bf16 parts,
    `ws` holds the three parts of W (`split_w`, as float32 tensors), and the
    six highest of the nine cross products are summed in float32, smallest
    first. Each elementary product of two bf16 values is exact in float32;
    the three products left out are at most 2^-24 of the largest."""
    m = [part.to(m2.dtype) for part in polyeval._split3_bf16(m2)]
    low = (m[0] @ ws[2] + m[1] @ ws[1]) + m[2] @ ws[0]
    mid = m[0] @ ws[1] + m[1] @ ws[0]
    return (low + mid) + m[0] @ ws[0]


def _quad_split_plain(name, x, basis):
    """(e, dE/dx) of the quadratic form over `basis` with the W product by
    `split_product`; float64 variables take the plain product (the split is
    a float32 device)."""
    if x.dtype != torch.float32:
        return polyeval.pip_quad_energy_and_grad(x, name, basis=basis)
    F, ws = _device_tables(name, 'split', x.dtype, x.device)
    m2 = polyeval.quad_basis(x, name, basis)
    wm = split_product(m2, ws)
    return torch.sum(m2 * wm, dim=-1), ((m2 * (2.0 * wm)) @ F) / x


def pip_quad_energy_grad_plain(name, x):
    """Plain twin of the exp/log quadratic-form kernel."""
    return _quad_split_plain(name, x, 'explog')


def pip_quad_product_energy_grad_plain(name, x):
    """Plain twin of the exact-product quadratic-form kernel."""
    return _quad_split_plain(name, x, 'gather')


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


QUAD_BLOCK_ROWS = 64     # a block is one warpgroup: `wgmma` owns 64 rows
QUAD_BLOCKS_PER_SM = 2   # resident at once (registers and shared memory)


def quad_launch_shape(p, n_sms):
    """(blocks, waves) of the tensor-core kernels for p rows on a card with
    n_sms SMs: one block per 64 rows, two resident per SM, so a wave is
    2 n_sms blocks. Two-warpgroup blocks sharing one ring of W (half the
    traffic of W from L2) were measured slower at every batch (PERF.md)."""
    blocks = -(-p // QUAD_BLOCK_ROWS)
    return blocks, blocks / (QUAD_BLOCKS_PER_SM * n_sms)


def _quad_launch(entry, wrapper, name, x):
    from mbpol_openmm_plugin_tpu_torch.ops import _build
    fn = getattr(_build.load(), entry)
    idx, wtiles, ftiles = _device_tables(name, 'quad', x.dtype, x.device)
    e, g = _outputs(x)
    _check(fn(x.data_ptr(), x.shape[0], x.shape[1], idx.shape[0], idx.data_ptr(),
              wtiles.data_ptr(), ftiles.data_ptr(), e.data_ptr(), g.data_ptr(), _stream()),
           wrapper.__name__)
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
