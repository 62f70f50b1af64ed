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
copy of x). All four run their contractions on the tensor cores. The
three quadratic-form kernels (one body, three bases) compute the product
m2 @ W as the six highest cross products of exact 3-way bf16 splits of m2
and W, summed in float32 (`split_product`, the scheme of the JAX kernels'
`_dot6`), and the gradient contraction z @ F as three exact bf16 passes
over the split of z (their `_dot3`); W's splits and F are laid out once on
the host in the tiles the kernel streams (`quad_kernel_tables`; the vech
kernel takes W and F in the natural vech order and no index table). The
monomial kernel computes mc = c * exp(sum of four logs) in float32, splits
it three ways and multiplies with the exponent matrix augmented by a
column of ones (`monomial_kernel_tables`: entries 0..4, exact in bf16), so
that the energy and the gradient fall out of one product of three exact
passes per tile of 16 monomials.

Dispatch: a CPU tensor goes to the wrapper's own plain twin (`*_plain`); a
CUDA float32 tensor goes to the kernel; anything else raises. There is no
fallback. The twins repeat the kernels' arithmetic in tensor operations
(the monomial twin in row chunks, so that [P, 33525] stays small, and
summing over the monomials in the kernel's blocks) and may
be called by name to compare and time them; nothing on the card's path
calls them. Float64 variables take the plain products (the splits are a
float32 device). Each wrapper counts its launches in its `launches` attribute.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

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
# The monomial kernel walks the monomials in tiles of K_TILE against
# K_TILE x V_PAD tiles of the augmented exponent matrix, which stream in
# stages of MONO_STAGE_TILES tiles.
MONO_STAGE_TILES = 8
# The kernel sums MONO_GROUP_TILES tiles in one sum of the tensor core's
# accumulator, adds that to a float32 inner sum, and adds the inner sum to
# the outer one every MONO_FLUSH_TILES tiles.
MONO_GROUP_TILES, MONO_FLUSH_TILES = 2, 32


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


# Position in a tile of the monomial of rank r in the kernel's order: one
# shared load of the kernel serves the monomials 2 t (t = 0..3) of a tile,
# the next ones 2 t + 1, 2 t + 8, 2 t + 9, so consecutive ranks go to the
# positions that load together.
_TILE_POSITIONS = (0, 2, 4, 6, 1, 3, 5, 7, 8, 10, 12, 14, 9, 11, 13, 15)
LA_STRIDE_BYTES = 72 * 4     # bytes per variable of the kernel's log x array (kXS floats)


class MonomialTables(NamedTuple):
    """Host tables of the monomial kernel (`monomial_kernel_tables`). The
    kernel streams `c`, `offsets` and `ettiles`; `order`, `factors` and
    `et_aug` serve the twin and the tests.

      order   [Mp] int64 (numpy): the monomial of `monomial_factors` at each
            place, nmono for padding;
      factors [Mp, 4] uint8 and c [Mp] float32 (numpy), in that order;
      offsets [Mp, 4] int32 (numpy): factors * LA_STRIDE_BYTES, the byte
            offsets the kernel adds to its row's slot of log x;
      et_aug  bfloat16 [Mp, V_PAD]: columns 0..V-1 the exponents (0..4, exact
            in bfloat16), column V one for every real monomial, so that
            mc @ et_aug holds dE/dlog x and, in column V, the energy;
      ettiles bfloat16 [Mp / K_TILE, V_PAD / 8, 2, 8, 8]: et_aug cut into
            tiles of K_TILE monomials in the layout of `_core_tiles`."""
    order: np.ndarray
    factors: np.ndarray
    c: np.ndarray
    offsets: np.ndarray
    et_aug: torch.Tensor
    ettiles: torch.Tensor


@functools.lru_cache(maxsize=None)
def monomial_kernel_tables(name):
    """`MonomialTables` of one polynomial, the monomials padded to Mp, a
    multiple of MONO_STAGE_TILES K_TILE (padding: factors V, c = 0, a zero row of Et) and
    put in the kernel's order: sorted by their factor lists, last slot
    first, and dealt within a tile to `_TILE_POSITIONS`. The four monomials
    one shared load serves then mostly hold the same variable or neighbouring
    ones in a slot, which is what the array of log x (LA_STRIDE_BYTES per
    variable, 8 mod 32 banks) serves without bank conflicts: 2.09 / 2.14
    wavefronts per 8-byte load (3B / 2B) against 2.50 in the file's order
    and 2 at best."""
    factors, c = monomial_factors(name)
    pip = polyeval.load_pip(name)
    nm, v = pip.nmono, pip.nvars
    if v >= V_PAD:
        raise ValueError(f'{name}: {v} variables and the energy column do not fit {V_PAD}')
    mp = -(-nm // (MONO_STAGE_TILES * K_TILE)) * MONO_STAGE_TILES * K_TILE
    fp = np.full((mp, MONO_SLOTS), v, np.uint8)
    fp[:nm] = factors
    rank = np.lexsort(tuple(fp[:, s] for s in range(MONO_SLOTS)))    # last slot is primary
    order = np.empty(mp, np.int64)
    order.reshape(-1, K_TILE)[:, _TILE_POSITIONS] = rank.reshape(-1, K_TILE)
    fp = fp[order]
    cp = np.append(c, np.zeros(mp - nm)).astype(np.float32)[order]
    expo = np.zeros((mp, V_PAD), np.float32)
    expo[:nm, :v] = pip.exponents
    expo[:nm, v] = 1.0
    et = torch.as_tensor(expo[order], dtype=torch.bfloat16)
    order = np.where(order < nm, order, nm)
    return MonomialTables(order, fp, cp, fp.astype(np.int32) * LA_STRIDE_BYTES, et,
                          _core_tiles(et, V_PAD)[0].contiguous())


def _tile_quad(F, W):
    """(bp, wtiles, ftiles): W padded with zeros to [Bp, Bp], Bp a multiple
    of N_CHUNK, split 3 ways (`split_w`) and cut into the tiles the kernels
    stream, and F padded to [Bp, V_PAD] and cut likewise (layouts in
    `quad_kernel_tables`)."""
    b, v = F.shape
    bp = -(-b // N_CHUNK) * N_CHUNK
    if v > V_PAD or F.max() > 2:
        raise ValueError(f'{v} variables / basis exponent {F.max()} do not fit the kernel '
                         'tables')
    Wp = np.zeros((bp, bp), np.float32)
    Wp[:b, :b] = W
    wtiles = torch.stack([_core_tiles(part, N_CHUNK) for part in split_w(Wp)], dim=2)
    Fp = torch.zeros(bp, V_PAD, dtype=torch.bfloat16)
    Fp[:b, :v] = torch.as_tensor(F, dtype=torch.bfloat16)
    ftiles = _core_tiles(Fp, V_PAD)[0].reshape(bp // N_CHUNK, N_CHUNK // K_TILE, V_PAD // 8,
                                               2, 8, 8)
    return bp, wtiles.contiguous(), ftiles.contiguous()


@functools.lru_cache(maxsize=None)
def quad_kernel_tables(name):
    """Host tables of the exp/log and exact-product quadratic-form kernels:

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
    bp, wtiles, ftiles = _tile_quad(F, W)
    idx = np.full(bp, v | v << 8, np.uint16)
    idx[:b] = ia | ib << 8
    return idx, wtiles, ftiles


def vech_factor_indices(va, bp=None):
    """(ia, ib) int64 of the natural vech order over va augmented variables,
    in the closed form the vech kernel uses: row i va - i (i - 1) / 2 + j - i
    is the pair (i, j), i <= j. Rows from va (va + 1) / 2 up to `bp` (the
    kernel's padding) are (va - 1, va - 1): 1 * 1 against zero rows of W."""
    b = va * (va + 1) // 2
    ia = np.full(b if bp is None else bp, va - 1, np.int64)
    ib = ia.copy()
    for i in range(va):
        o = i * va - i * (i - 1) // 2
        ia[o:o + va - i] = i
        ib[o:o + va - i] = np.arange(i, va)
    return ia, ib


@functools.lru_cache(maxsize=None)
def vech_kernel_tables(name):
    """(wtiles, ftiles) of the vech kernel: `vech_w` (raises for an
    asymmetric W) and F in the natural vech order, tiled as in
    `quad_kernel_tables`. There is no index table: the kernel derives a basis
    row's factor pair in closed form (`vech_factor_indices`)."""
    F, _ = polyeval.load_quad_vech(name)
    return _tile_quad(F, vech_w(name))[1:]


@functools.lru_cache(maxsize=None)
def _device_tables(name, kind, dtype, device):
    """Device-resident tables of one polynomial. For the kernels: kind
    'monomial' (factor offsets int32 [Mp, 4], c, the tiles of the augmented
    exponent matrix), 'quad' (`quad_kernel_tables`, idx as int16 bits) or
    'vech' (`vech_kernel_tables`). For the twins, as `dtype`: 'monomial_split'
    (factor indices int64 [Mp, 4], c, the augmented exponent matrix),
    'monomial_plain' (the same unpadded, with the plain exponent matrix),
    'split' or 'split_vech' (F and the three splits of W, in the file or the
    natural vech order)."""
    def dev(a, dt=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    if kind in ('monomial', 'monomial_split'):
        t = monomial_kernel_tables(name)
        if kind == 'monomial':
            return dev(t.offsets), dev(t.c), t.ettiles.to(device)
        return (dev(t.factors, torch.int64), dev(t.c, dtype),
                t.et_aug.to(device=device, dtype=dtype))
    if kind == 'monomial_plain':
        factors, c = monomial_factors(name)
        return dev(factors, torch.int64), dev(c, dtype), polyeval._pip_tables(name, dtype,
                                                                              device)[0]
    if kind == 'quad':
        idx, wtiles, ftiles = quad_kernel_tables(name)
        return dev(idx.view(np.int16)), wtiles.to(device), ftiles.to(device)
    if kind == 'vech':
        return tuple(t.to(device) for t in vech_kernel_tables(name))
    if kind in ('split', 'split_vech'):
        F, W = ((polyeval.load_quad_vech(name)[0], vech_w(name)) if kind == 'split_vech'
                else polyeval.load_quad(name))
        return dev(F, dtype), tuple(w.to(device=device, dtype=dtype) for w in split_w(W))
    raise ValueError(kind)


# ----------------------------------------------------------------------
# Plain PyTorch twins
# ----------------------------------------------------------------------

def blocked_split_product(parts, E):
    """sum over the parts of part @ E in float32, summed over the monomials
    as the monomial kernel sums them: `parts` = (hi, mid, lo) [R, Mp] as
    float32, E [Mp, N]. Each group of MONO_GROUP_TILES tiles is one sum from
    zero of its three products, smallest part first; the groups are added one
    at a time to an inner sum, and the inner sum to the outer one every
    MONO_FLUSH_TILES tiles (and at the end)."""
    hi, mid, lo = parts
    r, mp = hi.shape
    gk = MONO_GROUP_TILES * K_TILE
    groups, per = mp // gk, MONO_FLUSH_TILES // MONO_GROUP_TILES
    Eg = E.reshape(groups, gk, -1)

    def prod(a):
        return torch.bmm(a.reshape(r, groups, gk).transpose(0, 1), Eg)
    part = (prod(lo) + prod(mid)) + prod(hi)                         # [groups, R, N]
    blocks = -(-groups // per)
    part = torch.nn.functional.pad(part, (0, 0, 0, 0, 0, blocks * per - groups))
    part = part.reshape(blocks, per, r, -1)
    run = torch.zeros_like(part[:, 0])
    for j in range(per):
        run = run + part[:, j]
    acc = torch.zeros_like(run[0])
    for b in range(blocks):
        acc = acc + run[b]
    return acc


def pip_energy_grad_plain(name, x):
    """Plain twin of the monomial kernel: per monomial the sum of its four
    factor logs in slot order, exp, times c; that mc is split exactly three
    ways into bf16 and multiplied with the augmented exponent matrix in the
    kernel's blocks (`blocked_split_product`), which gives dE/dlog x and, in
    column V, the energy. Rows in chunks of PLAIN_CHUNK. Float64 variables
    take the plain sum and product."""
    split = x.dtype == torch.float32
    idx, c, E = _device_tables(name, 'monomial_split' if split else 'monomial_plain', x.dtype,
                               x.device)
    v = x.shape[1]
    e_out, g_out = [], []
    for xc in torch.split(x, PLAIN_CHUNK):
        la = torch.cat([torch.log(xc), torch.zeros_like(xc[:, :1])], dim=1)
        s = ((la[:, idx[:, 0]] + la[:, idx[:, 1]]) + la[:, idx[:, 2]]) + la[:, idx[:, 3]]
        mc = torch.exp(s) * c
        if split:
            r = blocked_split_product(
                tuple(part.to(x.dtype) for part in polyeval._split3_bf16(mc)), E)
            e_out.append(r[:, v])
            g_out.append(r[:, :v] / xc)
        else:
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
    F, ws = _device_tables(name, 'split_vech' if basis == 'vech' else 'split', x.dtype,
                           x.device)
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
    """Plain twin of the vech kernel: the split product over the natural
    vech basis (checks W's symmetry as the kernel's wrapper does)."""
    vech_w(name)
    return _quad_split_plain(name, x, 'vech')


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
    offsets, c, ettiles = _device_tables(name, 'monomial', x.dtype, x.device)
    e, g = _outputs(x)
    _check(lib.mbpol_pip_monomial(x.data_ptr(), x.shape[0], x.shape[1], ettiles.data_ptr(),
                                  offsets.data_ptr(), c.data_ptr(), ettiles.shape[0],
                                  e.data_ptr(), g.data_ptr(), _stream()), 'pip_energy_grad')
    pip_energy_grad.launches += 1
    return e, g


QUAD_BLOCK_ROWS = 64     # a block is one warpgroup: `wgmma` owns 64 rows
QUAD_BLOCKS_PER_SM = 2   # quadratic forms resident at once (registers, shared memory)
MONO_BLOCKS_PER_SM = 4   # monomial kernel (its launch bounds)


def launch_shape(p, n_sms, blocks_per_sm=QUAD_BLOCKS_PER_SM):
    """(blocks, waves) of the PIP kernels for p rows on a card with n_sms SMs:
    one block per 64 rows, `blocks_per_sm` resident per SM (the quadratic
    forms two, the monomial kernel MONO_BLOCKS_PER_SM), so a wave is
    blocks_per_sm n_sms blocks. Two-warpgroup blocks sharing one ring of W
    (half the traffic of W from L2) were measured slower at every batch
    (PERF.md)."""
    blocks = -(-p // QUAD_BLOCK_ROWS)
    return blocks, blocks / (blocks_per_sm * n_sms)


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
    wtiles, ftiles = _device_tables(name, 'vech', x.dtype, x.device)
    xat = polyeval.augmented(x).T.contiguous()            # [V+1, P], batch on the fast axis
    e, g = _outputs(x)
    _check(lib.mbpol_pip_quad_vech(xat.data_ptr(), x.shape[0], x.shape[1],
                                   wtiles.shape[0] * N_CHUNK, wtiles.data_ptr(),
                                   ftiles.data_ptr(), e.data_ptr(), g.data_ptr(), _stream()),
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
