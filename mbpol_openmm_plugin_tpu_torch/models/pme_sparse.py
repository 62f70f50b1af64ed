"""Sparse (water-pair list) PME electrostatics for large periodic boxes
(port of mbpol_openmm_plugin_tpu/models/pme_sparse.py).

The direct space runs over a padded water-pair list (O-O distance below
cutoff + dispersion.PAIR_MARGIN, plus the skin): per pair the 4 x 4 site-site block
is evaluated densely ([P, 4, 4] tensors), the same-water terms form one
[nmol, 4, 4] block, and per-water results are combined with segment sums.
The reciprocal space is models/pme.py's (separable spread, FFT
convolution, read-back, chunked over sites for large N). O(N) memory, no
kernel: this is the large-box mode without the CUDA kernels ('auto' picks
it above 512 waters on the CPU), plain PyTorch on either device.

The segment sums give the same bits on every run: the pair rows are sorted
once per evaluation (stable) by the water they add into, and
torch.segment_reduce sums each water's rows in that order, with no
atomics (an index_add on the card sums in a varying order). Padded pairs
fall outside every segment.

The physics is models/pme.py's (the same formulas and same-water scale
conventions; tests/test_torch_sparse.py holds it against the dense mode
and the JAX function). It needs the stride-4 OHHM layout (reshapes instead
of gathers) and cutoff <= box / 2, where one periodic image per pair is
all the cutoff holds. The SCF closures are models/electrostatics.py's, as
in the dense mode.
"""
from __future__ import annotations

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch.models import electrostatics as elec
from mbpol_openmm_plugin_tpu_torch.models import pme as pme_mod
from mbpol_openmm_plugin_tpu_torch.ops.elec_direct import bn_factors
from mbpol_openmm_plugin_tpu_torch.system import minimum_image
from mbpol_openmm_plugin_tpu_torch.utils import units
from mbpol_openmm_plugin_tpu_torch.utils.consts import device_const

_SQRT_PI = np.sqrt(np.pi)


def _slot_tables(params: elec.ElecParams, dtype, device):
    """The per-slot (O, H1, H2, M) tables: inverse damping products [4, 4]
    and the same-water TDD gammas [4, 4], on the device; and the
    cross-water Thole gammas TCC, TCD, TDD."""
    damping = np.asarray(params.damping, np.float64)
    if not (damping.reshape(-1, 4) == damping[:4]).all():
        raise ValueError('sparse electrostatics takes one damping value per water site slot')
    d16 = damping[:4] ** (1.0 / 6.0)
    th = np.asarray(params.thole, np.float64)
    is_o = np.array([True, False, False, False])
    gamma_intra = np.where(is_o[:, None] | is_o[None, :], th[elec.TDDOH], th[elec.TDDHH])
    return (device_const(1.0 / (d16[:, None] * d16[None, :]), dtype=dtype, device=device),
            device_const(gamma_intra, dtype=dtype, device=device),
            float(th[elec.TCC]), float(th[elec.TCD]), float(th[elec.TDD]))


class _Segments:
    """Per-water sums of pair rows: the rows of a pairs' a-side [P, ...]
    and b-side [P, ...] values go to waters ia and ib. The 2P row indices
    (padded rows: nmol, past every segment) are sorted once, stably, and
    each call sums each water's rows in that order."""

    def __init__(self, ia, ib, pair_mask, nmol):
        pad = torch.full_like(ia, nmol)
        idx = torch.cat([torch.where(pair_mask, ia, pad), torch.where(pair_mask, ib, pad)])
        sorted_idx, self.order = torch.sort(idx, stable=True)
        self.offsets = torch.searchsorted(
            sorted_idx, torch.arange(nmol + 1, device=idx.device, dtype=idx.dtype))

    def __call__(self, va, vb):
        tail = va.shape[1:]
        rows = torch.cat([va, vb]).reshape(2 * va.shape[0], -1)[self.order]
        out = torch.segment_reduce(rows, 'sum', offsets=self.offsets, axis=0, unsafe=True)
        return out.reshape((-1,) + tail)


class _PairBlocks:
    """The inter-water pair blocks [P, 4, 4] of the pairs (ia, ib) (their
    rows of the padded list, pair_mask [P]) on one device, and their
    per-water sums [nmol, 4, ...] (each pair's a-side rows to water ia, its
    b-side rows to water ib)."""

    def __init__(self, setup, pos4, q4, ia, ib, pair_mask, box, slot):
        nmol = pos4.shape[0]
        inv_damp, g_cc, g_cd, g_dd = slot
        alpha = setup.alpha
        self.ia, self.ib = ia, ib
        self.seg = _Segments(ia, ib, pair_mask, nmol)
        delta = minimum_image(pos4[ib][:, None, :, :] - pos4[ia][:, :, None, :], box)   # r_b - r_a
        r2 = torch.sum(delta * delta, dim=-1)
        within = pair_mask[:, None, None] & (r2 <= setup.cutoff ** 2)
        r = torch.sqrt(torch.where(within, r2, 1.0))
        inv_r = torch.where(within, 1.0 / r, 0.0)
        rr1, rr3, rr5, rr7 = inv_r, inv_r ** 3, 3.0 * inv_r ** 5, 15.0 * inv_r ** 7
        bn0, bn1, bn2, bn3 = (torch.where(within, b, 0.0) for b in bn_factors(alpha, r, inv_r))
        u = r * inv_damp
        s_cc = elec.thole_scales(u, g_cc, orders=(1, 3))
        s_cd = elec.thole_scales(u, g_cd, orders=(3, 5))
        s_dd = elec.thole_scales(u, g_dd, orders=(3, 5, 7))
        self.qa, self.qb = q4[ia], q4[ib]
        self.delta, self.within = delta, within
        # cross-water kdir = bn1 - (1 - s3cc) rr3 (models/pme.py's sign)
        self.kdir = torch.where(within, bn1 - (1.0 - s_cc[3]) * rr3, 0.0)
        self.pf1 = torch.where(within, (1.0 - s_dd[3]) * rr3 - bn1, 0.0)
        self.pf2 = torch.where(within, bn2 - (1.0 - s_dd[5]) * rr5, 0.0)
        self.k1 = torch.where(within, bn0 - rr1 * (1.0 - s_cc[1]), 0.0)
        self.w3 = torch.where(within, bn1 - rr3 * (1.0 - s_cd[3]), 0.0)
        self.w5 = torch.where(within, bn2 - rr5 * (1.0 - s_dd[5]), 0.0)
        self.t = dict(bn0=bn0, bn1=bn1, bn2=bn2, bn3=bn3, rr1=rr1, rr3=rr3, rr5=rr5, rr7=rr7,
                      s_cc=s_cc, s_cd=s_cd, s_dd=s_dd)

    def fixed_field(self):
        """The direct fixed field of the pairs, per water [nmol, 4, 3]."""
        kdir, delta = self.kdir, self.delta
        return self.seg(-torch.einsum('pab,pb,pabd->pad', kdir, self.qb, delta),
                        torch.einsum('pab,pa,pabd->pbd', kdir, self.qa, delta))

    def dipole_field(self, mu4):
        """The SCF dipole field of the pairs from mu4 [nmol, 4, 3]."""
        delta, pf1, pf2 = self.delta, self.pf1, self.pf2
        mua, mub = mu4[self.ia], mu4[self.ib]
        dotb = torch.einsum('pbd,pabd->pab', mub, delta)
        dota = torch.einsum('pad,pabd->pab', mua, delta)
        fa = torch.einsum('pab,pabd->pad', pf2 * dotb, delta) + torch.einsum('pab,pbd->pad',
                                                                              pf1, mub)
        fb = torch.einsum('pab,pabd->pbd', pf2 * dota, delta) + torch.einsum('pab,pad->pbd',
                                                                              pf1, mua)
        return self.seg(fa, fb)

    def energy_force_pot(self, mu4):
        """(the pairs' direct energy, their force rows [nmol, 4, 3] and
        potential [nmol, 4]) at the dipoles mu4."""
        t, delta, within = self.t, self.delta, self.within
        qa, qb = self.qa, self.qb
        mua, mub = mu4[self.ia], mu4[self.ib]
        dot_a = torch.einsum('pad,pabd->pab', mua, delta)      # mu_a . (r_b - r_a)
        dot_b = torch.einsum('pbd,pabd->pab', mub, delta)
        qq = qa[:, :, None] * qb[:, None, :]
        gli1 = qb[:, None, :] * dot_a - qa[:, :, None] * dot_b
        mumu = torch.einsum('pad,pbd->pab', mua, mub)
        s_cc, s_cd, s_dd = t['s_cc'], t['s_cd'], t['s_dd']
        e_pair = ((t['bn0'] - t['rr1'] * (1.0 - s_cc[1])) * qq
                  + 0.5 * (t['bn1'] - t['rr3'] * (1.0 - s_cd[3])) * gli1)
        e = torch.sum(torch.where(within, e_pair, 0.0))
        coeff = torch.where(within,
                            (t['bn1'] - (1.0 - s_cc[3]) * t['rr3']) * qq
                            + (t['bn2'] - t['rr5'] * (1.0 - s_cd[5])) * gli1
                            + (t['bn2'] - t['rr5'] * (1.0 - s_dd[5])) * mumu
                            - (t['bn3'] - t['rr7'] * (1.0 - s_dd[7])) * (dot_a * dot_b), 0.0)
        w5, w3 = self.w5, self.w3
        # F_ab acts -f on the a-sites and +f on the b-sites: the b-sites take
        # the negated a-row sums
        F = (coeff[..., None] * delta + (w5 * dot_b)[..., None] * mua[:, :, None, :]
             + (w5 * dot_a)[..., None] * mub[:, None, :, :]
             + (w3 * qa[:, :, None])[..., None] * mub[:, None, :, :]
             - (w3 * qb[:, None, :])[..., None] * mua[:, :, None, :])
        force4 = self.seg(torch.sum(F, dim=2), -torch.sum(F, dim=1))
        pot4 = self.seg(torch.einsum('pab,pb->pa', self.k1, qb) - torch.sum(w3 * dot_b, dim=2),
                        torch.einsum('pab,pa->pb', self.k1, qa) + torch.sum(w3 * dot_a, dim=1))
        return e, force4, pot4


def pme_electrostatics_sparse(params: elec.ElecParams, setup: pme_mod.PmeSetup, positions,
                              mol_pairs, pair_mask, mu0=None, box=None, tables=None, mesh=None):
    """PME energy (kJ/mol), forces (kJ/mol/nm) and diagnostics on a padded
    water-pair list.

    positions: [4 nmol, 3] nm, the stride-4 OHHM layout, M sites placed,
    molecules whole; mol_pairs: [P, 2] water index pairs whose minimum-image
    O-O distance is below cutoff + PAIR_MARGIN (any superset is exact);
    pair_mask: [P] bool, False on padded rows; mu0: optional dipole
    predictor (ASPC) or warm start; box: the evaluation's box (three
    floats; default setup.box); tables: `pme.site_tables` (built here when
    None); mesh: a parallel.mesh.Mesh whose lead device is the positions'
    (None: one device): the pair rows split in equal slabs, each shard's
    pair blocks and per-water partial sums on its device, the partial sums
    added on the lead in shard order, the reciprocal space split over the
    sites as in models/pme.py. The diagnostics are the dense mode's (SCF
    iterations, epsilon, converged, charges, induced dipoles, the site
    potential)."""
    dt, dev = positions.dtype, positions.device
    f_elec = units.ELECTRIC
    alpha = setup.alpha
    nmol = positions.shape[0] // 4
    box = pme_mod.box_tuple(setup, box)
    pscale = (device_const(setup.grid, dtype=dt, device=dev)
              / device_const(box, dtype=dt, device=dev))
    if tables is None:
        tables = pme_mod.site_tables(params, dt, dev)
    alpha_pol = tables['polarity']

    charges, dq_w = elec.assemble_charges(params, positions)
    q4 = charges.reshape(nmol, 4)
    pos4 = positions.reshape(nmol, 4, 3)

    # ---- inter-water pair blocks [P, 4, 4], by shard ----
    def blocks(d, lo, hi):
        inv_damp, _, g_cc, g_cd, g_dd = _slot_tables(params, dt, d)
        return d, _PairBlocks(setup, pos4.to(d), q4.to(d), mol_pairs[lo:hi, 0].to(d),
                              mol_pairs[lo:hi, 1].to(d), pair_mask[lo:hi].to(d), box,
                              (inv_damp, g_cc, g_cd, g_dd))

    if mesh is None:
        parts = [blocks(dev, 0, mol_pairs.shape[0])]
        lead = None
    else:
        from mbpol_openmm_plugin_tpu_torch.parallel import mesh as M
        parts = M.map_rows(mesh, mol_pairs.shape[0], blocks)
        lead = mesh

    def over_pairs(fn):
        """fn(blocks) of every shard's pair blocks, added on the lead device
        in shard order (each a tuple of tensors)."""
        from mbpol_openmm_plugin_tpu_torch.parallel.mesh import on_shard
        outs = []
        for d, pb in parts:
            with on_shard(d):
                outs.append(fn(pb))
        if lead is None:
            return outs[0]
        return tuple(M.sum_to_lead(lead, list(x)) for x in zip(*outs))

    # ---- same-water block [nmol, 4, 4] (always inside the cutoff) ----
    inv_damp, gamma_intra, _, _, _ = _slot_tables(params, dt, dev)
    delta_in = pos4[:, None, :, :] - pos4[:, :, None, :]
    offdiag = ~torch.eye(4, dtype=torch.bool, device=dev)
    r_in = torch.sqrt(torch.where(offdiag, torch.sum(delta_in * delta_in, dim=-1), 1.0))
    inv_r_in = torch.where(offdiag, 1.0 / r_in, 0.0)
    rr3_in, rr5_in, rr7_in = inv_r_in ** 3, 3.0 * inv_r_in ** 5, 15.0 * inv_r_in ** 7
    bn_in = [torch.where(offdiag, b, 0.0) for b in bn_factors(alpha, r_in, inv_r_in)]
    s_dd_in = elec.thole_scales(r_in * inv_damp, gamma_intra, orders=(3, 5, 7))

    # ---- fixed field: reciprocal + direct ----
    rgrid = pme_mod._Grid(setup, positions, box, mesh)
    phi = rgrid.charge_phi(charges)                                       # [N, 10]
    efield = (-pscale[None, :] * phi[:, 1:4]).reshape(nmol, 4, 3)
    efield = efield + over_pairs(lambda pb: (pb.fixed_field(),))[0]
    # same water: s3 := 2
    efield = efield - torch.einsum('mab,mb,mabd->mad', bn_in[1] - rr3_in, q4, delta_in)

    # ---- SCF ----
    pf1_in = (1.0 - s_dd_in[3]) * rr3_in - bn_in[1]
    pf2_in = bn_in[2] - (1.0 - s_dd_in[5]) * rr5_in
    self_term = (4.0 / 3.0) * alpha ** 3 / _SQRT_PI

    def field_fn(mu):
        mu4 = mu.reshape(nmol, 4, 3)
        dot_in = torch.einsum('mbd,mabd->mab', mu4, delta_in)
        field = (over_pairs(lambda pb: (pb.dipole_field(mu4.to(pb.ia.device)),))[0]
                 + torch.einsum('mab,mabd->mad', pf2_in * dot_in, delta_in)
                 + torch.einsum('mab,mbd->mad', pf1_in, mu4)).reshape(-1, 3)
        phid = rgrid.dipole_phi(mu, pscale)
        return field - pscale[None, :] * phid[:, 1:4] + self_term * mu

    scf = elec.make_scf(params)
    mu, diag = scf(efield.reshape(-1, 3) * alpha_pol[:, None], alpha_pol, field_fn,
                   params.target_epsilon, params.max_iterations, mu0=mu0)
    mu4 = mu.reshape(nmol, 4, 3)

    # ---- direct-space energy, forces and potential ----
    e_pairs, force4, pot4 = over_pairs(lambda pb: pb.energy_force_pot(mu4.to(pb.ia.device)))
    # same water: the scales are zero
    dot_in = torch.einsum('mbd,mabd->mab', mu4, delta_in)
    dot_in_a = torch.einsum('mad,mabd->mab', mu4, delta_in)
    qq_in = q4[:, :, None] * q4[:, None, :]
    gli1_in = q4[:, None, :] * dot_in_a - q4[:, :, None] * dot_in
    e_in = (bn_in[0] - inv_r_in) * qq_in + 0.5 * (bn_in[1] - rr3_in) * gli1_in
    e_direct = e_pairs + 0.5 * torch.sum(e_in)
    # same water: the same structure with the qq / cd scales zeroed; the
    # block holds ordered pairs, so the row sums apply directly
    w5_in = bn_in[2] - rr5_in * (1.0 - s_dd_in[5])
    w3_in = bn_in[1] - rr3_in
    coeff_in = (w3_in * qq_in + (bn_in[2] - rr5_in) * gli1_in
                + w5_in * torch.einsum('mad,mbd->mab', mu4, mu4)
                - (bn_in[3] - rr7_in * (1.0 - s_dd_in[7])) * (dot_in_a * dot_in))
    F_in = (coeff_in[..., None] * delta_in + (w5_in * dot_in)[..., None] * mu4[:, :, None, :]
            + (w5_in * dot_in_a)[..., None] * mu4[:, None, :, :]
            + (w3_in * q4[:, :, None])[..., None] * mu4[:, None, :, :]
            - (w3_in * q4[:, None, :])[..., None] * mu4[:, :, None, :])
    forces = -f_elec * (force4 + torch.sum(F_in, dim=2)).reshape(-1, 3)

    pot4 = (pot4 + torch.einsum('mab,mb->ma', bn_in[0] - inv_r_in, q4)
            - torch.sum(w3_in * dot_in, dim=2))
    pot = pot4.reshape(-1)

    # ---- reciprocal fixed and induced, self (the dense mode's) ----
    e_recip_fixed = 0.5 * torch.sum(charges * phi[:, 0])
    forces = forces - f_elec * (charges[:, None] * phi[:, 1:4] * pscale[None, :])
    pot = pot + phi[:, 0]
    phid = rgrid.dipole_phi(mu, pscale)
    smu = mu * pscale[None, :]
    e_recip_ind = 0.5 * torch.sum(smu * phi[:, 1:4])
    hess = device_const(pme_mod._HESS, device=dev)
    f_ind = 2.0 * torch.einsum('ndk,nk->nd', phi[:, hess] + phid[:, hess], smu)
    f_ind = f_ind + 2.0 * charges[:, None] * phid[:, 1:4]
    forces = forces - 0.5 * f_elec * pscale[None, :] * f_ind
    pot = pot + phid[:, 0]
    e_self = -(alpha / _SQRT_PI) * torch.sum(charges * charges)
    pot = pot + charges * (-2.0 * alpha / _SQRT_PI)

    if params.include_charge_redistribution and dq_w is not None:
        forces = forces + elec.charge_derivative_forces(params, pot, dq_w)

    energy = f_elec * (e_direct + e_recip_fixed + e_recip_ind + e_self)
    return energy, forces, dict(**diag, charges=charges, induced_dipoles=mu, site_potential=pot)
