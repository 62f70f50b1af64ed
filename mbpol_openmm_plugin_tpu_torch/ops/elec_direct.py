"""Direct-space PME electrostatics pair work: two hand-written CUDA kernels
and their plain PyTorch twins (counterpart of
mbpol_openmm_plugin_tpu/ops/elec_pallas.py).

K1 `fixed_field_and_scf_factors` replaces the Pallas kernel
`_fixed_field_kernel_tri` (and `_fixed_field_kernel`): the direct fixed
charge field [N,3] and the full symmetric SCF factor matrices s3/s5 [N,N].
K2 `direct_energy_force_pot` replaces `_pair_force_kernel_tri` (and
`_pair_force_kernel`): the direct-space energy, pair forces [N,3] and
per-site potential [N] from the induced dipoles.

What bounds them on the H100 and the design: see csrc/elec_direct.cu (the
triangular form of the TPU kernels: one block per tile pair ti <= tj in
the order of `tile_pairs`, each unordered pair's chain once, row and
column partials into an [n_tiles, K, N] scratch that a second kernel sums
in a fixed order, so no atomics and the same bits on every run; s3/s5
written whole and exactly symmetric).

Dispatch: a CPU tensor goes to the plain twin; a CUDA float32 tensor goes
to the kernel; anything else raises. There is no fallback. Before either,
every wrapper (and those of ops/elec_direct_bs.py) refuses a box shorter
than twice the cutoff (`DirectConsts.check_box`). The full twins
(`*_plain`) are written from the XLA dense formulas of models/pme.py with
torch.special.erfc and the ported gammq34; the triangular twins
(`*_tri_plain`) run the same formulas in the kernels' decomposition (tiles,
tile-pair order, partials, the tile sum's order). Both may be called by
name to compare and time them. Each kernel wrapper counts its launches in the
`launches` attribute of the wrapper function.

Packed sites [N, 8]: x, y, z, q, damping^(-1/6), molecule id, is-oxygen,
unused (see `pack_sites`).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from mbpol_openmm_plugin_tpu_torch.models.electrostatics import (TCC, TCD, TDD,
                                                                 TDDHH, TDDOH,
                                                                 thole_scales)
from mbpol_openmm_plugin_tpu_torch.system import box_tensor

_X, _Y, _Z, _Q, _D16, _MOL, _ISO = range(7)
NS = 8
_SQRT_PI = math.sqrt(math.pi)


@dataclasses.dataclass(frozen=True)
class DirectConsts:
    """Physics constants of the direct-space sum (kernel arguments, so a new
    box needs no rebuild)."""
    alpha: float
    cutoff: float
    thole: tuple     # (TCC, TCD, TDD, TDDOH, TDDHH)
    box: tuple       # (lx, ly, lz) nm

    @classmethod
    def from_setup(cls, setup, thole, box=None):
        """From a PmeSetup, the Thole parameters and the evaluation's box
        (three floats; default setup.box)."""
        return cls(alpha=float(setup.alpha), cutoff=float(setup.cutoff),
                   thole=tuple(float(t) for t in thole),
                   box=tuple(float(b) for b in (setup.box if box is None else box)))

    def check_box(self):
        """Refuse a box shorter than twice the cutoff on some axis: the
        minimum image of the pair chains (csrc/elec_common.cuh
        min_image_fast) is exact only while every pair inside the cutoff is
        nearer than half the box, which a barostat's shrinking box could
        break."""
        if min(self.box) < 2.0 * self.cutoff:
            raise ValueError(f'box {self.box} nm is shorter than twice the direct-space cutoff '
                             f'{self.cutoff} nm on some axis')

    def kernel_args(self):
        return (self.alpha, self.cutoff ** 2, *self.thole, *self.box)


def pack_sites(positions, charges, d16_inv, mol_index, is_o):
    """[N, 8] packed per-site scalars (contiguous, in positions' dtype)."""
    cols = [positions, charges[:, None], d16_inv[:, None],
            mol_index[:, None].to(positions.dtype), is_o[:, None].to(positions.dtype),
            torch.zeros_like(charges)[:, None]]
    return torch.cat(cols, dim=1).contiguous()


# ----------------------------------------------------------------------
# Plain PyTorch twins (the XLA dense formulas of models/pme.py)
# ----------------------------------------------------------------------

def bn_factors(alpha, r, inv_r):
    """Ewald real-space bn0..bn3 (ewaldScalingReal)."""
    ralpha = alpha * r
    bn = [torch.special.erfc(ralpha) * inv_r]
    alsq2 = 2.0 * alpha * alpha
    alsq2n = 1.0 / (_SQRT_PI * alpha)
    exp2a = torch.exp(-(ralpha * ralpha))
    inv_r2 = inv_r * inv_r
    for n in range(1, 4):
        alsq2n = alsq2n * alsq2
        bn.append((float(2 * n - 1) * bn[-1] + alsq2n * exp2a) * inv_r2)
    return bn


def pair_delta(positions, box):
    """[N, N, 3] minimum-image displacements r_j - r_i."""
    return _delta(positions, positions, box)


def _delta(prow, pcol, box):
    """[..., I, J, 3] minimum-image displacements r_j - r_i between row
    positions [..., I, 3] and column positions [..., J, 3]."""
    b = box_tensor(box, prow)
    d = pcol[..., None, :, :] - prow[..., :, None, :]
    return d - torch.floor(d / b + 0.5) * b


def _pair_terms(srow, scol, notself, c: DirectConsts, need_cc1):
    """Pair tensors [..., I, J] between row sites srow [..., I, 8] and
    column sites scol [..., J, 8], masked to in-cutoff pairs where
    `notself` [..., I, J] holds."""
    th = c.thole
    delta = _delta(srow[..., :3], scol[..., :3], c.box)
    r2 = torch.sum(delta * delta, dim=-1)
    r = torch.sqrt(torch.where(notself, r2, 1.0))
    within = notself & (r * r <= c.cutoff * c.cutoff)

    def cut(x):
        return torch.where(within, x, 0.0)

    inv_r = torch.where(notself, 1.0 / r, 0.0)
    t = dict(delta=delta, within=within)
    t['bn0'], t['bn1'], t['bn2'], t['bn3'] = [cut(b) for b in bn_factors(c.alpha, r, inv_r)]
    t['rr1c'] = cut(inv_r)
    t['rr3c'] = cut(inv_r ** 3)
    t['rr5c'] = cut(3.0 * inv_r ** 5)
    t['rr7c'] = cut(15.0 * inv_r ** 7)

    u = r * srow[..., :, None, _D16] * scol[..., None, :, _D16]
    same_mol = srow[..., :, None, _MOL] == scol[..., None, :, _MOL]
    one_is_o = (srow[..., :, None, _ISO] + scol[..., None, :, _ISO]) > 0.5
    g = torch.as_tensor([th[TDD], th[TDDOH], th[TDDHH]], dtype=srow.dtype,
                        device=srow.device)
    gamma_dd = torch.where(same_mol, torch.where(one_is_o, g[1], g[2]), g[0])
    t['same_mol'] = same_mol
    t['s_cc'] = thole_scales(u, th[TCC], orders=(1, 3) if need_cc1 else (3,))
    t['s_cd'] = thole_scales(u, th[TCD], orders=(3, 5))
    t['s_dd'] = thole_scales(u, gamma_dd, orders=(3, 5, 7))
    return t


def _dense_notself(sites):
    n = sites.shape[0]
    return ~torch.eye(n, dtype=torch.bool, device=sites.device)


def _k1_pair(t):
    """K1's per-pair values from `_pair_terms`: (kdir, the field coupling
    without the charge, s3, s5), each [..., I, J] and zero outside the
    cutoff."""
    within, rr3c = t['within'], t['rr3c']
    # same-water pairs keep only the reciprocal correction bn1 - rr3; the
    # cross-water damping sign is the fixed one of models/pme.py
    s3cc_field = torch.where(t['same_mol'], 0.0, t['s_cc'][3])
    kdir = torch.where(within, t['bn1'] - (1.0 - s3cc_field) * rr3c, 0.0)
    s3 = torch.where(within, (1.0 - t['s_dd'][3]) * rr3c - t['bn1'], 0.0)
    s5 = torch.where(within, t['bn2'] - (1.0 - t['s_dd'][5]) * t['rr5c'], 0.0)
    return kdir, s3, s5


def k1_terms(srow, scol, notself, c: DirectConsts):
    """K1's formulas between row and column sites: (field rows [..., I, 3],
    s3 [..., I, J], s5 [..., I, J])."""
    t = _pair_terms(srow, scol, notself, c, need_cc1=False)
    kdir, s3, s5 = _k1_pair(t)
    field = -torch.einsum('...ij,...j,...ijd->...id', kdir, scol[..., _Q], t['delta'])
    return field, s3, s5


def _k2_pair(t, srow, scol, mu_row, mu_col):
    """K2's per-pair values from `_pair_terms`, given the row and column
    dipoles: a dict of [..., I, J] tensors (dot_i = mu_i . d, dot_j =
    mu_j . d; e_pair, coeff, w5, w3 and k1 zero outside the cutoff)."""
    delta, within, same_mol = t['delta'], t['within'], t['same_mol']
    bn0, bn1, bn2, bn3 = t['bn0'], t['bn1'], t['bn2'], t['bn3']
    rr1c, rr3c, rr5c, rr7c = t['rr1c'], t['rr3c'], t['rr5c'], t['rr7c']
    s_cc, s_cd, s_dd = t['s_cc'], t['s_cd'], t['s_dd']
    qi, qj = srow[..., _Q], scol[..., _Q]

    mu_dot_d_i = torch.einsum('...id,...ijd->...ij', mu_row, delta)
    mu_dot_d_j = torch.einsum('...jd,...ijd->...ij', mu_col, delta)
    qq = qi[..., :, None] * qj[..., None, :]
    gli1 = qj[..., None, :] * mu_dot_d_i - qi[..., :, None] * mu_dot_d_j
    mumu = mu_row @ mu_col.transpose(-1, -2)

    s1cc_e = torch.where(same_mol, 0.0, s_cc[1])
    s3cd_e = torch.where(same_mol, 0.0, s_cd[3])
    s3cc_f = torch.where(same_mol, 0.0, s_cc[3])
    s5cd_f = torch.where(same_mol, 0.0, s_cd[5])

    e_pair = (bn0 - rr1c * (1.0 - s1cc_e)) * qq \
        + 0.5 * (bn1 - rr3c * (1.0 - s3cd_e)) * gli1

    coeff = (bn1 - (1.0 - s3cc_f) * rr3c) * qq \
        + (bn2 - rr5c * (1.0 - s5cd_f)) * gli1 \
        + (bn2 - rr5c * (1.0 - s_dd[5])) * mumu \
        - (bn3 - rr7c * (1.0 - s_dd[7])) * (mu_dot_d_i * mu_dot_d_j)
    return dict(dot_i=mu_dot_d_i, dot_j=mu_dot_d_j,
                e_pair=torch.where(within, e_pair, 0.0),
                coeff=torch.where(within, coeff, 0.0),
                w5=torch.where(within, bn2 - rr5c * (1.0 - s_dd[5]), 0.0),
                w3=torch.where(within, bn1 - rr3c * (1.0 - s3cd_e), 0.0),
                k1=torch.where(within, bn0 - rr1c * (1.0 - s1cc_e), 0.0))


def k2_terms(srow, scol, notself, mu_row, mu_col, c: DirectConsts):
    """K2's formulas between row and column sites, given the row and column
    dipoles [..., I, 3] / [..., J, 3]: per row (half pair-energy sum
    [..., I], force [..., I, 3], potential [..., I])."""
    t = _pair_terms(srow, scol, notself, c, need_cc1=True)
    p = _k2_pair(t, srow, scol, mu_row, mu_col)
    qi, qj = srow[..., _Q], scol[..., _Q]
    w5, w3, dot_i, dot_j = p['w5'], p['w3'], p['dot_i'], p['dot_j']
    e_row = 0.5 * torch.sum(p['e_pair'], dim=-1)
    force = torch.einsum('...ij,...ijd->...id', p['coeff'], t['delta'])
    force = force + mu_row * torch.sum(w5 * dot_j, dim=-1)[..., None] + (w5 * dot_i) @ mu_col
    w3q = torch.einsum('...ij,...j->...i', w3, qj)
    force = force + qi[..., None] * (w3 @ mu_col) - mu_row * w3q[..., None]
    pot = torch.einsum('...ij,...j->...i', p['k1'], qj) - torch.sum(w3 * dot_j, dim=-1)
    return e_row, force, pot


def fixed_field_and_scf_factors_plain(sites, c: DirectConsts):
    """Plain twin of K1: (field [N,3], s3 [N,N], s5 [N,N])."""
    return k1_terms(sites, sites, _dense_notself(sites), c)


def direct_energy_force_pot_plain(sites, mu, c: DirectConsts):
    """Plain twin of K2: (e_direct scalar, force [N,3], pot [N])."""
    e_row, force, pot = k2_terms(sites, sites, _dense_notself(sites), mu, mu, c)
    return torch.sum(e_row), force, pot


# ----------------------------------------------------------------------
# Triangular twins: the kernels' decomposition (tiles, tile-pair order,
# row and column partials in the scratch layout, the tile sum's order)
# ----------------------------------------------------------------------

TILE = 32               # the kernels' tile (csrc/elec_direct.cu kTile, which checks it)
TRI_CHUNK = 1 << 20     # site pairs per chunk of tile pairs in the twins
SUM_GROUPS = 8          # tile groups of the kernels' tile sum (kSumGroups)


def tile_pairs(nt, device=None):
    """(ti, tj) [nt (nt + 1) / 2] of the kernels' blocks, in their folded
    order (csrc/elec_direct.cu tile_pair): each run of nt + 1 blocks holds
    row tile r's pairs (r, r .. nt - 1), then row tile nt - 1 - r's
    (nt - 1 - r .. nt - 1), so every run has the same work (nt - 1 full
    tiles and two diagonal ones; for odd nt the last run is the middle row
    tile alone)."""
    p = torch.arange(nt * (nt + 1) // 2, device=device)
    r, c = p // (nt + 1), p % (nt + 1)
    first = c < nt - r
    ti = torch.where(first, r, nt - 1 - r)
    tj = torch.where(first, r + c, nt - 1 - r + c - (nt - r))
    return ti, tj


def _tri_chunks(sites):
    """Per chunk of tile pairs: (ti, tj, row site index [P, T], column site
    index [P, T], row sites [P, T, 8], column sites, pair mask [P, T, T]:
    both sites real, and r < c in a diagonal tile)."""
    n = sites.shape[0]
    nt = -(-n // TILE)
    padded = torch.cat([sites, sites.new_zeros(nt * TILE - n, NS)])
    ti, tj = tile_pairs(nt, sites.device)
    lane = torch.arange(TILE, device=sites.device)
    upper = lane[:, None] < lane[None, :]
    step = TRI_CHUNK // (TILE * TILE)
    for a in range(0, ti.shape[0], step):
        ci, cj = ti[a:a + step], tj[a:a + step]
        gi, gj = ci[:, None] * TILE + lane, cj[:, None] * TILE + lane
        mask = ((gi < n)[:, :, None] & (gj < n)[:, None, :]
                & ((ci != cj)[:, None, None] | upper))
        yield ci, cj, gi, gj, padded[gi], padded[gj], mask


def _put_partials(partv, ci, cj, gi, gj, row, col):
    """Row sums [P, T, K] into the slot of partner tile tj, column sums into
    that of ti; a diagonal tile's sites get row + col. partv: the scratch
    [nt, K, Np] viewed as [nt, Np, K]."""
    diag = ci == cj
    off = ~diag
    partv[cj[off, None], gi[off]] = row[off]
    partv[ci[off, None], gj[off]] = col[off]
    partv[ci[diag, None], gi[diag]] = row[diag] + col[diag]


def _tile_sum(part, n):
    """[K, n]: the scratch [nt, K, Np] summed over tiles in the kernels'
    order: the tiles of each of SUM_GROUPS groups [g nt / SUM_GROUPS,
    (g + 1) nt / SUM_GROUPS) in order, then the groups in order."""
    nt = part.shape[0]
    total = None
    for g in range(SUM_GROUPS):
        acc = torch.zeros_like(part[0])
        for b in range(g * nt // SUM_GROUPS, (g + 1) * nt // SUM_GROUPS):
            acc = acc + part[b]
        total = acc if total is None else total + acc
    return total[:, :n]


def fixed_field_and_scf_factors_tri_plain(sites, c: DirectConsts):
    """Triangular twin of K1, in the kernel's decomposition: (field [N,3],
    s3 [N,N], s5 [N,N]). s3/s5 are exactly symmetric with a zero
    diagonal."""
    n = sites.shape[0]
    nt = -(-n // TILE)
    part = sites.new_zeros(nt, 3, nt * TILE)
    s3 = sites.new_zeros(nt * TILE, nt * TILE)
    s5 = sites.new_zeros(nt * TILE, nt * TILE)
    for ci, cj, gi, gj, srow, scol, mask in _tri_chunks(sites):
        t = _pair_terms(srow, scol, mask, c, need_cc1=False)
        kdir, b3, b5 = _k1_pair(t)
        w = kdir[..., None] * t['delta']
        # field: row i gets -q_j kdir d, column j gets +q_i kdir d
        row = -torch.einsum('pj,pijd->pid', scol[..., _Q], w)
        col = torch.einsum('pi,pijd->pjd', srow[..., _Q], w)
        _put_partials(part.permute(0, 2, 1), ci, cj, gi, gj, row, col)
        diag = (ci == cj)[:, None, None]
        for out, b in ((s3, b3), (s5, b5)):
            out[gi[:, :, None], gj[:, None, :]] = torch.where(diag, b + b.transpose(1, 2), b)
            off = ~diag[:, 0, 0]
            out[gj[off, :, None], gi[off, None, :]] = b[off].transpose(1, 2)
    return _tile_sum(part, n).T, s3[:n, :n], s5[:n, :n]


def direct_energy_force_pot_tri_plain(sites, mu, c: DirectConsts):
    """Triangular twin of K2, in the kernel's decomposition: (e_direct
    scalar, force [N,3], pot [N]); each unordered pair's energy counted
    once."""
    n = sites.shape[0]
    nt = -(-n // TILE)
    part = sites.new_zeros(nt, 5, nt * TILE)
    mu_pad = torch.cat([mu, mu.new_zeros(nt * TILE - n, 3)])
    for ci, cj, gi, gj, srow, scol, mask in _tri_chunks(sites):
        mi, mj = mu_pad[gi], mu_pad[gj]
        t = _pair_terms(srow, scol, mask, c, need_cc1=True)
        p = _k2_pair(t, srow, scol, mi, mj)
        qi, qj = srow[..., _Q], scol[..., _Q]
        w5, w3, dot_i, dot_j = p['w5'], p['w3'], p['dot_i'], p['dot_j']
        # the force on i of each pair; the column side is its negative
        f = (p['coeff'][..., None] * t['delta'] + mi[:, :, None] * (w5 * dot_j)[..., None]
             + (w5 * dot_i)[..., None] * mj[:, None] + qi[:, :, None, None] * (w3[..., None]
             * mj[:, None]) - mi[:, :, None] * (w3 * qj[:, None])[..., None])
        pot_i = p['k1'] * qj[:, None] - w3 * dot_j
        pot_j = p['k1'] * qi[:, :, None] + w3 * dot_i
        row = torch.cat([f.sum(2), pot_i.sum(2)[..., None], p['e_pair'].sum(2)[..., None]], -1)
        col = torch.cat([-f.sum(1), pot_j.sum(1)[..., None], torch.zeros_like(pot_j[:, 0, :, None])],
                        -1)
        _put_partials(part.permute(0, 2, 1), ci, cj, gi, gj, row, col)
    out = _tile_sum(part, n)
    return torch.sum(out[4]), out[:3].T, out[3]


# ----------------------------------------------------------------------
# Kernel wrappers: CPU -> twin, CUDA float32 -> kernel, else raise
# ----------------------------------------------------------------------

def _on_kernel(*tensors):
    """True when the call goes to the CUDA kernel; False for CPU tensors."""
    devs = {t.device.type for t in tensors}
    if devs == {'cpu'}:
        return False
    if devs != {'cuda'}:
        raise ValueError(f'tensors on mixed or unsupported devices: {devs}')
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f'the CUDA kernels take float32 tensors, got {t.dtype}')
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError('the CUDA kernels take contiguous 16-byte aligned tensors')
    return True


def _check(rc, name):
    if rc != 0:
        raise RuntimeError(f'{name}: CUDA launch failed with cudaError {rc}')


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _partials(n, k, like):
    """The kernels' row/column partials scratch [n_tiles, k, n] (every
    entry written by one block, so left uninitialized)."""
    nt = -(-n // TILE)
    return torch.empty((nt, k, n), dtype=like.dtype, device=like.device)


def fixed_field_and_scf_factors(sites, c: DirectConsts):
    """K1: (field [N,3], s3 [N,N], s5 [N,N]) from packed sites [N,8]."""
    if sites.dim() != 2 or sites.shape[1] != NS:
        raise ValueError(f'packed sites must be [N, {NS}], got {tuple(sites.shape)}')
    c.check_box()
    if not _on_kernel(sites):
        return fixed_field_and_scf_factors_plain(sites, c)
    from mbpol_openmm_plugin_tpu_torch.ops import _build
    lib = _build.load()
    n = sites.shape[0]
    field = torch.empty((n, 3), dtype=sites.dtype, device=sites.device)
    s3 = torch.empty((n, n), dtype=sites.dtype, device=sites.device)
    s5 = torch.empty((n, n), dtype=sites.dtype, device=sites.device)
    part = _partials(n, 3, sites)
    _check(lib.mbpol_fixed_field_scf(sites.data_ptr(), n, *c.kernel_args(), TILE,
                                     part.data_ptr(), field.data_ptr(), s3.data_ptr(),
                                     s5.data_ptr(), _stream()), 'fixed_field_and_scf_factors')
    fixed_field_and_scf_factors.launches += 1
    return field, s3, s5


def direct_energy_force_pot(sites, mu, c: DirectConsts):
    """K2: (e_direct scalar, force [N,3], pot [N]) from packed sites [N,8]
    and induced dipoles mu [N,3]."""
    n = sites.shape[0]
    if sites.dim() != 2 or sites.shape[1] != NS or tuple(mu.shape) != (n, 3):
        raise ValueError(f'expected sites [N, {NS}] and mu [N, 3], got '
                         f'{tuple(sites.shape)} and {tuple(mu.shape)}')
    c.check_box()
    if not _on_kernel(sites, mu):
        return direct_energy_force_pot_plain(sites, mu, c)
    from mbpol_openmm_plugin_tpu_torch.ops import _build
    lib = _build.load()
    force = torch.empty((n, 3), dtype=sites.dtype, device=sites.device)
    pot = torch.empty((n,), dtype=sites.dtype, device=sites.device)
    e_row = torch.empty((n,), dtype=sites.dtype, device=sites.device)
    part = _partials(n, 5, sites)
    _check(lib.mbpol_direct_efp(sites.data_ptr(), mu.data_ptr(), n, *c.kernel_args(), TILE,
                                part.data_ptr(), force.data_ptr(), pot.data_ptr(),
                                e_row.data_ptr(), _stream()), 'direct_energy_force_pot')
    direct_energy_force_pot.launches += 1
    return torch.sum(e_row), force, pot


fixed_field_and_scf_factors.launches = 0
direct_energy_force_pot.launches = 0

KERNELS = (fixed_field_and_scf_factors, direct_energy_force_pot)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
