"""Direct-space PME electrostatics pair work: two hand-written CUDA kernels
and their plain PyTorch twins (counterpart of
mbpol_openmm_plugin_tpu/ops/elec_pallas.py).

K1 `fixed_field_and_scf_factors` replaces the Pallas kernel
`_fixed_field_kernel_tri` (and `_fixed_field_kernel`): the direct fixed
charge field [N,3] and the full symmetric SCF factor matrices s3/s5 [N,N].
K2 `direct_energy_force_pot` replaces `_pair_force_kernel_tri` (and
`_pair_force_kernel`): the direct-space energy, pair forces [N,3] and
per-site potential [N] from the induced dipoles.

What bounds them on the H100 and the design: see csrc/elec_direct.cu (one
block per row tile loops over all columns; s3/s5 stores coalesced; row
sums reduced inside the block, so no atomics and deterministic results).

Dispatch: a CPU tensor goes to the plain twin; a CUDA float32 tensor goes
to the kernel; anything else raises. There is no fallback. The twins
(`*_plain`) are written from the XLA dense formulas of models/pme.py with
torch.special.erfc and the ported gammq34, and may be called by name to
compare and time them. Each kernel wrapper counts its launches in the
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
    def from_setup(cls, setup, thole):
        return cls(alpha=float(setup.alpha), cutoff=float(setup.cutoff),
                   thole=tuple(float(t) for t in thole),
                   box=tuple(float(b) for b in setup.box))

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
    b = torch.as_tensor(box, dtype=prow.dtype, device=prow.device)
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


def k1_terms(srow, scol, notself, c: DirectConsts):
    """K1's formulas between row and column sites: (field rows [..., I, 3],
    s3 [..., I, J], s5 [..., I, J])."""
    t = _pair_terms(srow, scol, notself, c, need_cc1=False)
    within, rr3c = t['within'], t['rr3c']
    # same-water pairs keep only the reciprocal correction bn1 - rr3; the
    # cross-water damping sign is the fixed one of models/pme.py
    s3cc_field = torch.where(t['same_mol'], 0.0, t['s_cc'][3])
    kdir = torch.where(within, t['bn1'] - (1.0 - s3cc_field) * rr3c, 0.0)
    field = -torch.einsum('...ij,...j,...ijd->...id', kdir, scol[..., _Q], t['delta'])
    s3 = torch.where(within, (1.0 - t['s_dd'][3]) * rr3c - t['bn1'], 0.0)
    s5 = torch.where(within, t['bn2'] - (1.0 - t['s_dd'][5]) * t['rr5c'], 0.0)
    return field, s3, s5


def k2_terms(srow, scol, notself, mu_row, mu_col, c: DirectConsts):
    """K2's formulas between row and column sites, given the row and column
    dipoles [..., I, 3] / [..., J, 3]: per row (half pair-energy sum
    [..., I], force [..., I, 3], potential [..., I])."""
    t = _pair_terms(srow, scol, notself, c, need_cc1=True)
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
    e_row = 0.5 * torch.sum(torch.where(within, e_pair, 0.0), dim=-1)

    coeff = (bn1 - (1.0 - s3cc_f) * rr3c) * qq \
        + (bn2 - rr5c * (1.0 - s5cd_f)) * gli1 \
        + (bn2 - rr5c * (1.0 - s_dd[5])) * mumu \
        - (bn3 - rr7c * (1.0 - s_dd[7])) * (mu_dot_d_i * mu_dot_d_j)
    coeff = torch.where(within, coeff, 0.0)
    force = torch.einsum('...ij,...ijd->...id', coeff, delta)

    w5 = torch.where(within, bn2 - rr5c * (1.0 - s_dd[5]), 0.0)
    force = force + mu_row * torch.sum(w5 * mu_dot_d_j, dim=-1)[..., None] \
        + (w5 * mu_dot_d_i) @ mu_col
    w3 = torch.where(within, bn1 - rr3c * (1.0 - s3cd_e), 0.0)
    w3q = torch.einsum('...ij,...j->...i', w3, qj)
    force = force + qi[..., None] * (w3 @ mu_col) - mu_row * w3q[..., None]

    k1 = torch.where(within, bn0 - rr1c * (1.0 - s1cc_e), 0.0)
    pot = torch.einsum('...ij,...j->...i', k1, qj) - torch.sum(w3 * mu_dot_d_j, dim=-1)
    return e_row, force, pot


def fixed_field_and_scf_factors_plain(sites, c: DirectConsts):
    """Plain twin of K1: (field [N,3], s3 [N,N], s5 [N,N])."""
    return k1_terms(sites, sites, _dense_notself(sites), c)


def direct_energy_force_pot_plain(sites, mu, c: DirectConsts):
    """Plain twin of K2: (e_direct scalar, force [N,3], pot [N])."""
    e_row, force, pot = k2_terms(sites, sites, _dense_notself(sites), mu, mu, c)
    return torch.sum(e_row), force, pot


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


def fixed_field_and_scf_factors(sites, c: DirectConsts):
    """K1: (field [N,3], s3 [N,N], s5 [N,N]) from packed sites [N,8]."""
    if sites.dim() != 2 or sites.shape[1] != NS:
        raise ValueError(f'packed sites must be [N, {NS}], got {tuple(sites.shape)}')
    if not _on_kernel(sites):
        return fixed_field_and_scf_factors_plain(sites, c)
    from mbpol_openmm_plugin_tpu_torch.ops import _build
    lib = _build.load()
    n = sites.shape[0]
    field = torch.empty((n, 3), dtype=sites.dtype, device=sites.device)
    s3 = torch.empty((n, n), dtype=sites.dtype, device=sites.device)
    s5 = torch.empty((n, n), dtype=sites.dtype, device=sites.device)
    _check(lib.mbpol_fixed_field_scf(sites.data_ptr(), n, *c.kernel_args(),
                                     field.data_ptr(), s3.data_ptr(), s5.data_ptr(),
                                     _stream()), 'fixed_field_and_scf_factors')
    fixed_field_and_scf_factors.launches += 1
    return field, s3, s5


def direct_energy_force_pot(sites, mu, c: DirectConsts):
    """K2: (e_direct scalar, force [N,3], pot [N]) from packed sites [N,8]
    and induced dipoles mu [N,3]."""
    n = sites.shape[0]
    if sites.dim() != 2 or sites.shape[1] != NS or tuple(mu.shape) != (n, 3):
        raise ValueError(f'expected sites [N, {NS}] and mu [N, 3], got '
                         f'{tuple(sites.shape)} and {tuple(mu.shape)}')
    if not _on_kernel(sites, mu):
        return direct_energy_force_pot_plain(sites, mu, c)
    from mbpol_openmm_plugin_tpu_torch.ops import _build
    lib = _build.load()
    force = torch.empty((n, 3), dtype=sites.dtype, device=sites.device)
    pot = torch.empty((n,), dtype=sites.dtype, device=sites.device)
    e_row = torch.empty((n,), dtype=sites.dtype, device=sites.device)
    _check(lib.mbpol_direct_efp(sites.data_ptr(), mu.data_ptr(), n, *c.kernel_args(),
                                force.data_ptr(), pot.data_ptr(), e_row.data_ptr(),
                                _stream()), 'direct_energy_force_pot')
    direct_energy_force_pot.launches += 1
    return torch.sum(e_row), force, pot


fixed_field_and_scf_factors.launches = 0
direct_energy_force_pot.launches = 0

KERNELS = (fixed_field_and_scf_factors, direct_energy_force_pot)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
