"""Many-body polarization: parameters, Thole damping, geometry-dependent
charges, the induced-dipole SCF closures and the cluster (NoCutoff)
electrostatics (port of mbpol_openmm_plugin_tpu/models/electrostatics.py).

- TTM4-F style charges from the Partridge-Schwenke dipole-moment surface,
  with their exact Jacobian dq/dr;
- MB-pol Thole damping factors of orders 1/3/5/7 (the order-1 factor uses
  the regularized incomplete gamma Q(3/4, x));
- the SOR fixed-point loop (polarSOR = 0.55), the DIIS/Anderson-accelerated
  loop and the Kolafa ASPC predictor-corrector closure for MD;
- `cluster_electrostatics`: energy, forces and dipoles of a non-periodic
  system over dense masked [N, N] tensors (plain PyTorch: the JAX package
  has no kernel on this path), and from it `system_moments` and
  `electrostatic_potential_on_grid`.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch import _data
from mbpol_openmm_plugin_tpu_torch.models.one_body import vander
from mbpol_openmm_plugin_tpu_torch.ops.gamma import gammq34
from mbpol_openmm_plugin_tpu_torch.system import index_tensor
from mbpol_openmm_plugin_tpu_torch.utils import tracing, units
from mbpol_openmm_plugin_tpu_torch.utils.consts import device_const

# Thole parameter indices
TCC, TCD, TDD, TDDOH, TDDHH = 0, 1, 2, 3, 4

_POLAR_SOR = 0.55
_GAMMA_3_4 = 1.2254167024651776451290983034  # Gamma(3/4)


@dataclasses.dataclass(frozen=True)
class ElecParams:
    """Static per-particle electrostatics parameters (numpy)."""
    thole: np.ndarray            # [5] TCC,TCD,TDD,TDDOH,TDDHH
    damping: np.ndarray          # [N] damping factors
    polarity: np.ndarray         # [N] polarizabilities (nm^3)
    mol_index: np.ndarray        # [N]
    atom_type: np.ndarray        # [N] 0=O,1=H,2=M
    charges: np.ndarray          # [N] fixed charges (no redistribution)
    include_charge_redistribution: bool = True
    target_epsilon: float = 1e-7
    max_iterations: int = 200
    scf_method: str = 'sor'      # 'sor' | 'diis' | 'aspc'
    aspc_k: int = 3
    aspc_n_corr: int = 1
    scf_eps_floor: Optional[float] = None
    # water site indices for charge redistribution (None for 3-site waters)
    o_index: Optional[np.ndarray] = None
    h1_index: Optional[np.ndarray] = None
    h2_index: Optional[np.ndarray] = None
    m_index: Optional[np.ndarray] = None

    @classmethod
    def for_system(cls, system, **kw):
        """Parameters for a water System (XML values), per site from its
        class, so that any site layout gets its own (the JAX function tiles
        the OHHM values, right only for the standard layout)."""
        ff = _data.load('forcefield')
        if system.n_ions:
            raise NotImplementedError('electrostatics with ions (parity with reference)')
        per_class = np.stack([ff['atom_O'], ff['atom_H'], ff['atom_M']])
        vals = per_class[np.asarray(system.atom_class)]
        return cls(
            thole=ff['thole'], damping=vals[:, 1], polarity=vals[:, 2],
            mol_index=system.mol_index, atom_type=np.minimum(system.atom_class, 2),
            charges=vals[:, 0], o_index=system.o_index, h1_index=system.h1_index,
            h2_index=system.h2_index, m_index=system.m_index, **kw)


def thole_scales(u, gamma, orders=(1, 3, 5, 7)):
    """Damping-only scale factors {order: scale} for u = r / damp with
    damp = (A_i A_j)^(1/6) (getAndScaleInverseRs, justScale=True)."""
    ratio = u ** 4
    ex = torch.exp(-gamma * ratio)
    out = {}
    s3 = 1.0 - ex
    if 1 in orders:
        out[1] = s3 + gamma ** 0.25 * u * _GAMMA_3_4 * gammq34(gamma * ratio)
    if 3 in orders:
        out[3] = s3
    s5 = s3 - (4.0 / 3.0) * gamma * ex * ratio
    if 5 in orders:
        out[5] = s5
    if 7 in orders:
        out[7] = s5 - (4.0 / 15.0) * gamma * (4.0 * gamma * ratio - 1.0) * ex * ratio
    return out


# ----------------------------------------------------------------------
# Geometry-dependent water charges (TTM4-F / Partridge-Schwenke DMS)
# ----------------------------------------------------------------------

_GAMMA_M = 0.426706882
_DMS = dict(costhe=-0.24780227221366464506, reoh=0.958649, b1D=1.0,
            a=0.2999, b=-0.6932, c0=1.0099, c1=-0.1801, c2=0.0892,
            bohr_a=0.52917721092)


@functools.lru_cache(maxsize=None)
def _dms_tables(dtype, device):
    d = _data.load('dms')
    idx = [torch.as_tensor(d[k][1:] - 1, device=device) for k in ('idxD0', 'idxD1', 'idxD2')]
    return idx, torch.as_tensor(d['coefD'][1:], dtype=dtype, device=device), float(d['coefD'][0])


def water_charges(pos_w):
    """Charges [nmol, 3] = (qH1, qH2, qM) of waters pos_w [nmol, 3, 3] (O,H1,H2
    in nm); qO is identically 0. Mirrors computeWaterCharge."""
    k = _DMS
    (i0, i1, i2), coef, coef0 = _dms_tables(pos_w.dtype, pos_w.device)
    o, h1, h2 = pos_w[:, 0], pos_w[:, 1], pos_w[:, 2]
    roh1 = (h1 - o) * units.NM_TO_ANGSTROM
    roh2 = (h2 - o) * units.NM_TO_ANGSTROM
    d1 = torch.sqrt(torch.sum(roh1 * roh1, dim=-1))
    d2 = torch.sqrt(torch.sum(roh2 * roh2, dim=-1))
    costh = torch.sum(roh1 * roh2, dim=-1) / (d1 * d2)

    efac = torch.exp(-k['b1D'] * ((d1 - k['reoh']) ** 2 + (d2 - k['reoh']) ** 2))
    x1 = (d1 - k['reoh']) / k['reoh']
    x2 = (d2 - k['reoh']) / k['reoh']
    x3 = costh - k['costhe']
    # powers by iterated multiplication (NaN-free derivative at x == 0)
    v1, v2, v3 = vander(x1), vander(x2), vander(x3)
    p1 = torch.sum(coef * v1[:, i0] * v2[:, i1] * v3[:, i2], dim=-1)
    p2 = torch.sum(coef * v1[:, i1] * v2[:, i0] * v3[:, i2], dim=-1)

    pl1 = costh
    pl2 = 0.5 * (3.0 * pl1 * pl1 - 1.0)
    pc0 = k['a'] * (d1 ** k['b'] + d2 ** k['b']) * (k['c0'] + pl1 * k['c1'] + pl2 * k['c2'])
    q_h1 = coef0 + p1 * efac + pc0 * k['bohr_a']
    q_h2 = coef0 + p2 * efac + pc0 * k['bohr_a']

    gamma1 = 1.0 - _GAMMA_M
    g2div1 = (_GAMMA_M / 2.0) / gamma1
    return torch.stack([q_h1 + g2div1 * (q_h1 + q_h2),
                        q_h2 + g2div1 * (q_h1 + q_h2),
                        -(q_h1 + q_h2) / gamma1], dim=-1)


def water_charges_and_derivatives(pos_w):
    """Charges [nmol, 3] and dq/dr [nmol, 3 (atom O,H1,H2), 3 (charge
    H1,H2,M), 3 (xyz)] in e/nm.

    Molecules are independent, so the Jacobian is nine forward-mode
    products, one per (atom, xyz) tangent applied to every molecule at
    once, batched with vmap (the counterpart of the JAX package's
    vmap(jacfwd))."""
    tangents = torch.eye(9, dtype=pos_w.dtype, device=pos_w.device).reshape(9, 1, 3, 3)

    def column(t):
        return torch.func.jvp(water_charges, (pos_w,), (t.expand_as(pos_w),))

    q, dq = torch.func.vmap(column, out_dims=(None, 0))(tangents)   # dq [9, nmol, 3q]
    dq = dq.reshape(3, 3, -1, 3).permute(2, 0, 3, 1)             # [nmol, atom, q, xyz]
    return q, dq


def _contiguous(params: ElecParams, n):
    """True when the sites are the stride-4 OHHM block of waters only."""
    nmol = len(params.o_index)
    return 4 * nmol == n and bool(np.array_equal(params.o_index, 4 * np.arange(nmol)))


def assemble_charges(params: ElecParams, positions):
    """Per-site charge vector [N] and dq/dr tensors for the full system."""
    n = len(params.damping)
    if not params.include_charge_redistribution:
        return device_const(params.charges, dtype=positions.dtype,
                            device=positions.device), None
    nmol = len(params.o_index)
    if _contiguous(params, n):
        pos_w = positions.reshape(nmol, 4, 3)[:, :3]
        q_w, dq_w = water_charges_and_derivatives(pos_w)
        zero = torch.zeros((nmol, 1), dtype=positions.dtype, device=positions.device)
        return torch.cat([zero, q_w], dim=1).reshape(-1), dq_w
    pos_w = positions[index_tensor(
        np.stack([params.o_index, params.h1_index, params.h2_index], 1), positions)]
    q_w, dq_w = water_charges_and_derivatives(pos_w)
    charges = torch.zeros(n, dtype=positions.dtype, device=positions.device)
    for k, idx in enumerate((params.h1_index, params.h2_index, params.m_index)):
        charges = charges.index_put((index_tensor(idx, positions),), q_w[:, k])
    return charges, dq_w


def charge_derivative_forces(params: ElecParams, phi, dq_w):
    """Forces [N, 3] (kJ/mol/nm) from the geometry dependence of the charges:
    -ELECTRIC * dq/dr contracted with the per-site potential phi [N] at the
    H1, H2 and M sites, on the O, H1 and H2 rows."""
    f = units.ELECTRIC
    n = phi.shape[0]
    nmol = len(params.o_index)
    if _contiguous(params, n):
        f_atoms = -f * torch.einsum('masd,ms->mad', dq_w, phi.reshape(nmol, 4)[:, 1:])
        pad = torch.zeros((nmol, 1, 3), dtype=phi.dtype, device=phi.device)
        return torch.cat([f_atoms, pad], dim=1).reshape(-1, 3)
    site_idx = index_tensor(np.stack([params.h1_index, params.h2_index, params.m_index], 1), phi)
    f_atoms = -f * torch.einsum('masd,ms->mad', dq_w, phi[site_idx])
    atom_idx = index_tensor(np.stack([params.o_index, params.h1_index, params.h2_index], 1), phi)
    # every atom row appears once: the scatter has no collisions
    return torch.zeros((n, 3), dtype=phi.dtype, device=phi.device).index_add(
        0, atom_idx.reshape(-1), f_atoms.reshape(-1, 3))


# ----------------------------------------------------------------------
# Induced-dipole SCF
# ----------------------------------------------------------------------

def dipole_field(mu, s3, s5, delta):
    """Field at i from dipoles at j: sum_j s3_ij mu_j + s5_ij (mu_j . D_ij) D_ij
    with D = delta (r_j - r_i). s3/s5 carry signs and r powers. Leading
    batch dimensions are allowed (the block-sparse twin passes [c, ...])."""
    proj = torch.einsum('...ijd,...jd->...ij', delta, mu)
    return s3 @ mu + torch.einsum('...ij,...ijd->...id', s5 * proj, delta)


def f32_eps_floor(override=None):
    """Lowest SCF convergence target honored at float32 (default 1e-4, the
    historical f32 floor of the convergence metric)."""
    return 1e-4 if override is None else float(override)


def _metric(dmu, n):
    return _POLAR_SOR * units.DEBYE * torch.sqrt(torch.sum(dmu * dmu) / n)


def _count_solve(iterations):
    """A converged solve's counters: one host read of epsilon an iteration."""
    tracing.count('scf_solves')
    tracing.count('scf_iterations', iterations)
    tracing.count('host_reads', iterations)


def scf_induced_dipoles(efield_alpha, alpha, field_fn, target_epsilon,
                        max_iterations, mu0=None, eps_floor=None):
    """SOR fixed-point iteration for the induced dipoles.

    efield_alpha: [N,3] polarity * fixed field; alpha: [N]; field_fn(mu):
    the dipole field [N,3] (direct + reciprocal + self). Stops on
    convergence, divergence (epsilon increase) or max iterations, like
    convergeInduceDipoles. The stop test reads epsilon on the host once per
    iteration.
    Returns (mu, dict(iterations, epsilon, converged)) with tensor values.
    """
    n = efield_alpha.shape[0]
    if efield_alpha.dtype == torch.float32:
        # the Force-API default (1e-7) is below f32 resolution of the metric
        target_epsilon = max(target_epsilon, f32_eps_floor(eps_floor))
    mu = efield_alpha if mu0 is None else mu0
    prev = math.inf
    it = 0
    with tracing.span('models.electrostatics.scf'):
        while True:
            dmu = efield_alpha + field_fn(mu) * alpha[:, None] - mu
            mu = mu + _POLAR_SOR * dmu
            eps = _metric(dmu, n)
            it += 1
            with tracing.span('models.electrostatics.scf_stop_test'):
                eps_h = float(eps)
            converged = eps_h < target_epsilon
            if converged or prev < eps_h or it >= max_iterations:
                break
            prev = eps_h
    _count_solve(it)
    dev = mu.device
    return mu, dict(iterations=torch.tensor(it, device=dev), epsilon=eps,
                    converged=torch.tensor(converged, device=dev))


def aspc_omega(k):
    """Kolafa ASPC relaxation weight omega = (k+2)/(2k+3)."""
    return (k + 2.0) / (2.0 * k + 3.0)


def aspc_predictor_coefficients(k):
    """Kolafa ASPC predictor coefficients B_j over the last k+2 corrected
    dipole sets, newest first:
        B_j = (-1)^(j+1) * j * C(2k+4, k+2-j) / C(2k+2, k+1),  j = 1..k+2."""
    if not 0 <= int(k) == k:
        raise ValueError(f'ASPC predictor order must be a non-negative integer, got {k!r}')
    denom = math.comb(2 * k + 2, k + 1)
    return np.asarray([(-1) ** (j + 1) * j * math.comb(2 * k + 4, k + 2 - j) / denom
                       for j in range(1, k + 3)], np.float64)


def scf_induced_dipoles_aspc(efield_alpha, alpha, field_fn, target_epsilon,
                             max_iterations, mu0=None, eps_floor=None,
                             omega=5.0 / 9.0, n_corr=1):
    """Always-stable predictor-corrector (Kolafa ASPC) dipole closure.

    n_corr SOR-damped iterations applied to the caller's predictor mu0, then
    mu = omega * mu + (1 - omega) * mu0. The corrector must be the
    SOR-damped step: the bare Picard map has spectral radius > 1 on water
    and makes the closure unstable. Without a predictor (mu0=None, a
    one-shot evaluation) fall back to the converged SOR loop.
    """
    if mu0 is None:
        return scf_induced_dipoles(efield_alpha, alpha, field_fn, target_epsilon,
                                   max_iterations, eps_floor=eps_floor)
    n = efield_alpha.shape[0]
    mu = mu0
    for _ in range(int(n_corr)):
        dmu = efield_alpha + field_fn(mu) * alpha[:, None] - mu
        mu = mu + _POLAR_SOR * dmu
    mu = omega * mu + (1.0 - omega) * mu0
    # no convergence decision in ASPC mode; the health flag fires when the
    # predictor residual runs away (1000x the target)
    eps = _metric(dmu, n)
    healthy = eps < 1e3 * max(target_epsilon, 1e-8)
    return mu, dict(iterations=torch.ones((), dtype=torch.int64, device=mu.device),
                    epsilon=eps, converged=healthy)


def scf_induced_dipoles_diis(efield_alpha, alpha, field_fn, target_epsilon,
                             max_iterations, mu0=None, eps_floor=None, depth=5):
    """DIIS/Anderson-accelerated SCF for the induced dipoles.

    Fixed-point map g(mu) = efield_alpha + alpha * field_fn(mu), residual
    r = g(mu) - mu. Each iteration extrapolates over the last `depth`
    (g, r) pairs (Anderson type II: minimize |r_0 + D theta| with D_i =
    r_{i+1} - r_0, a Tikhonov term 1e-8 * trace and a unit diagonal on the
    slots not filled yet, without which the first iterations are singular),
    then mu <- g_0 + sum_i theta_i (g_{i+1} - g_0). The metric and the stop
    test (read on the host once per iteration) are the SOR loop's, so
    `converged` means the same thing; there is no divergence stop.
    Returns (mu, dict(iterations, epsilon, converged)) with tensor values.
    """
    n = efield_alpha.shape[0]
    dt, dev = efield_alpha.dtype, efield_alpha.device
    if dt == torch.float32:
        target_epsilon = max(target_epsilon, f32_eps_floor(eps_floor))
    m_dim = depth - 1
    mu = efield_alpha if mu0 is None else mu0
    gs = torch.zeros((depth,) + tuple(mu.shape), dtype=dt, device=dev)
    rs = torch.zeros_like(gs)
    eye = torch.eye(m_dim, dtype=dt, device=dev)
    slots = torch.arange(m_dim, device=dev)
    it = 0
    with tracing.span('models.electrostatics.scf'):
        while True:
            g = efield_alpha + field_fn(mu) * alpha[:, None]
            r = g - mu
            eps = _metric(r, n)
            gs = torch.cat([g[None], gs[:-1]])
            rs = torch.cat([r[None], rs[:-1]])
            valid = slots < min(it, m_dim)
            d = torch.where(valid[:, None, None], rs[1:] - rs[0], 0.0).reshape(m_dim, -1)
            a = d @ d.T
            a = (a + 1e-8 * (torch.trace(a) + 1e-30) * eye
                 + torch.diag(torch.where(valid, 0.0, 1.0).to(dt)))
            b = -(d @ rs[0].reshape(-1))
            chol, _ = torch.linalg.cholesky_ex(a)
            theta = torch.where(valid, torch.cholesky_solve(b[:, None], chol)[:, 0], 0.0)
            mu = gs[0] + torch.einsum('k,knd->nd', theta, gs[1:] - gs[0])
            it += 1
            with tracing.span('models.electrostatics.scf_stop_test'):
                converged = float(eps) < target_epsilon
            if converged or it >= max_iterations:
                break
    _count_solve(it)
    return mu, dict(iterations=torch.tensor(it, device=dev), epsilon=eps,
                    converged=torch.tensor(converged, device=dev))


def make_scf(params):
    """SCF solver for params.scf_method ('sor' | 'diis' | 'aspc')."""
    floor = params.scf_eps_floor
    if params.scf_method == 'aspc':
        return functools.partial(scf_induced_dipoles_aspc,
                                 omega=aspc_omega(params.aspc_k),
                                 n_corr=params.aspc_n_corr, eps_floor=floor)
    if params.scf_method == 'sor':
        return functools.partial(scf_induced_dipoles, eps_floor=floor)
    if params.scf_method == 'diis':
        return functools.partial(scf_induced_dipoles_diis, eps_floor=floor)
    raise ValueError(f'unknown scf_method {params.scf_method!r}')


# ----------------------------------------------------------------------
# Cluster (NoCutoff) energy and forces
# ----------------------------------------------------------------------

def _pair_tensors(params: ElecParams, positions, rows=None):
    """Dense geometry and Thole tensors of a non-periodic system, for the
    rows [lo, hi) = `rows` (default all) against every site: delta (r_j -
    r_i), r (1 at i = j before the square root), u = r / (A_i A_j)^(1/6),
    the masks and the TDD gamma selection (same molecule: TDDOH if either
    site is an O, else TDDHH; other molecules TDD). Masks are applied with
    torch.where, so every shape is static."""
    dt, dev = positions.dtype, positions.device
    n = positions.shape[0]
    lo, hi = (0, n) if rows is None else rows
    delta = positions[None, :, :] - positions[lo:hi, None, :]
    r2 = torch.sum(delta * delta, dim=-1)
    if rows is None:
        notself = ~torch.eye(n, dtype=torch.bool, device=dev)
    else:
        notself = (torch.arange(lo, hi, device=dev)[:, None]
                   != torch.arange(n, device=dev)[None, :])
    r = torch.sqrt(torch.where(notself, r2, 1.0))
    d16 = device_const(np.asarray(params.damping, np.float64) ** (1.0 / 6.0), dtype=dt,
                       device=dev)
    u = r / (d16[lo:hi, None] * d16[None, :])
    mol = device_const(np.asarray(params.mol_index, np.int64), device=dev)
    same_mol = mol[lo:hi, None] == mol[None, :]
    is_o = device_const(np.asarray(params.atom_type) == 0, device=dev)
    th = [device_const(float(x), dtype=dt, device=dev) for x in params.thole]
    gamma_dd = torch.where(same_mol,
                           torch.where(is_o[lo:hi, None] | is_o[None, :], th[TDDOH], th[TDDHH]),
                           th[TDD])
    return dict(delta=delta, r=r, u=u, notself=notself, diff_mol=~same_mol & notself,
                gamma_dd=gamma_dd)


class _ClusterRows:
    """The cluster electrostatics' pair tensors of the rows [lo, hi) against
    every site, on the positions' device."""

    def __init__(self, params: ElecParams, positions, charges, rows=None):
        th = [float(x) for x in params.thole]
        t = _pair_tensors(params, positions, rows)
        self.lo, self.hi = (0, positions.shape[0]) if rows is None else rows
        self.delta, self.notself, self.diff_mol = t['delta'], t['notself'], t['diff_mol']
        self.charges = charges
        inv_r = torch.where(self.notself, 1.0 / t['r'], 0.0)
        self.rr1, self.rr3 = inv_r, inv_r ** 3
        self.rr5, self.rr7 = 3.0 * inv_r ** 5, 15.0 * inv_r ** 7
        self.s_cc = thole_scales(t['u'], th[TCC], orders=(1, 3))
        self.s_cd = thole_scales(t['u'], th[TCD], orders=(3, 5))
        self.s_dd = thole_scales(t['u'], t['gamma_dd'], orders=(3, 5, 7))
        # SCF factors (TDD damping, no exclusions)
        self.s3 = torch.where(self.notself, -self.rr3 * self.s_dd[3], 0.0)
        self.s5 = torch.where(self.notself, self.rr5 * self.s_dd[5], 0.0)

    def fixed_field(self):
        """Damped charge field of the rows, same-water pairs excluded."""
        k3 = torch.where(self.diff_mol, self.rr3 * self.s_cc[3], 0.0)
        return -torch.einsum('ij,j,ijd->id', k3, self.charges, self.delta)

    def dipole_field(self, mu):
        return dipole_field(mu, self.s3, self.s5, self.delta)

    def energy_forces_phi(self, mu, with_phi):
        """(the rows' half pair-energy sum, pair force rows [rows, 3], and
        with_phi the damped potential rows of the charge-derivative forces,
        else None) at the dipoles mu [N, 3]."""
        delta, notself, diff_mol = self.delta, self.notself, self.diff_mol
        rr1, rr3, rr5, rr7 = self.rr1, self.rr3, self.rr5, self.rr7
        s_cc, s_cd, s_dd = self.s_cc, self.s_cd, self.s_dd
        charges, mu_r = self.charges, mu[self.lo:self.hi]
        q_r = charges[self.lo:self.hi]
        mu_dot_d_i = torch.einsum('id,ijd->ij', mu_r, delta)     # mu_i . (r_j - r_i)
        mu_dot_d_j = torch.einsum('jd,ijd->ij', mu, delta)       # mu_j . (r_j - r_i)
        gl0 = torch.where(diff_mol, q_r[:, None] * charges[None, :], 0.0)
        gli0 = torch.where(diff_mol, charges[None, :] * mu_dot_d_i - q_r[:, None] * mu_dot_d_j,
                           0.0)
        e_pair = rr1 * gl0 * s_cc[1] + 0.5 * rr3 * gli0 * s_cd[3]
        energy = torch.sum(torch.where(notself, e_pair, 0.0))

        gfi0 = (rr5 * gli0 * s_cd[5] + rr5 * (mu_r @ mu.T) * s_dd[5]
                - rr7 * (mu_dot_d_i * mu_dot_d_j) * s_dd[7])
        coeff = torch.where(notself, rr3 * gl0 * s_cc[3] + gfi0, 0.0)
        force_pair = torch.einsum('ij,ijd->id', coeff, delta)
        w5 = torch.where(notself, rr5 * s_dd[5], 0.0)
        force_pair = (force_pair + torch.einsum('ij,ij,id->id', w5, mu_dot_d_j, mu_r)
                      + torch.einsum('ij,jd->id', w5 * mu_dot_d_i, mu))
        # (q_i mu_j - q_j mu_i) rr3 s3cd summed over j
        w3 = torch.where(diff_mol, rr3 * s_cd[3], 0.0)
        force_pair = force_pair + q_r[:, None] * (w3 @ mu) - mu_r * (w3 @ charges)[:, None]
        phi = None
        if with_phi:
            # damped (TCC, orders 1/3) potentials at each site from every
            # site of the other molecules
            phi = (torch.einsum('ij,j->i', torch.where(diff_mol, s_cc[1] * rr1, 0.0), charges)
                   + torch.einsum('ij,ij->i', torch.where(diff_mol, s_cc[3] * rr3, 0.0),
                                  -mu_dot_d_j))
        return energy, force_pair, phi


def cluster_electrostatics(params: ElecParams, positions, mu0=None, mesh=None):
    """Energy (kJ/mol), forces (kJ/mol/nm) and diagnostics (SCF iterations,
    epsilon, converged, charges, induced_dipoles) of a non-periodic system.

    positions: [N, 3] nm with the M sites placed; mu0: optional dipole
    predictor (ASPC) or warm start; mesh: a parallel.mesh.Mesh whose lead
    device is the positions' (None: one device), the pair rows split in
    equal slabs, each slab's tensors on its shard's device, the SCF's field
    gathered and the energies added on the lead. The fixed field excludes
    same-molecule pairs, the SCF field (TDD damping) excludes only i = j;
    the forces use the reference's explicit formulas at the converged
    dipoles (the reference's second 'polar' dipole copy is identical in
    MB-pol and is folded in), plus the charge-derivative forces through
    dq/dr."""
    dt, dev = positions.dtype, positions.device
    f = units.ELECTRIC
    charges, dq_w = assemble_charges(params, positions)
    alpha = device_const(params.polarity, dtype=dt, device=dev)
    with_phi = params.include_charge_redistribution and dq_w is not None

    if mesh is None:
        slabs = [(dev, _ClusterRows(params, positions, charges))]
    else:
        from mbpol_openmm_plugin_tpu_torch.parallel import mesh as M
        slabs = M.map_rows(mesh, positions.shape[0], lambda d, lo, hi: (d, _ClusterRows(
            params, positions.to(d), charges.to(d), (lo, hi))))

    def over(fn):
        """[fn(device, slab)] of the slabs in shard order, each on its shard."""
        from mbpol_openmm_plugin_tpu_torch.parallel.mesh import on_shard
        out = []
        for d, slab in slabs:
            with on_shard(d):
                out.append(fn(d, slab))
        return out

    def rows(parts):
        return parts[0] if len(parts) == 1 else torch.cat([p.to(dev) for p in parts])

    efield = rows(over(lambda d, slab: slab.fixed_field()))
    mu, diag = make_scf(params)(
        efield * alpha[:, None], alpha,
        lambda m: rows(over(lambda d, slab: slab.dipole_field(m.to(d)))),
        params.target_epsilon, params.max_iterations, mu0=mu0)

    outs = over(lambda d, slab: slab.energy_forces_phi(mu.to(d), with_phi))
    e_pairs = outs[0][0]
    for o in outs[1:]:
        e_pairs = e_pairs + o[0].to(dev)
    force_pair = rows([o[1] for o in outs])
    phi = rows([o[2] for o in outs]) if with_phi else None
    energy = 0.5 * f * e_pairs
    forces = -f * force_pair
    if with_phi:
        forces = forces + charge_derivative_forces(params, phi, dq_w)
    return energy, forces, dict(**diag, charges=charges, induced_dipoles=mu)


def system_moments(params: ElecParams, positions, masses):
    """Net charge, dipole and traceless quadrupole about the centre of mass,
    induced dipoles included, in the reference's 13-vector convention:
    charge (e), dipole[3] (Debye), quadrupole[9] (Debye A)."""
    _, _, diag = cluster_electrostatics(params, positions)
    charges, mu = diag['charges'], diag['induced_dipoles']
    m = device_const(np.asarray(masses), dtype=positions.dtype, device=positions.device)
    local = positions - torch.sum(m[:, None] * positions, dim=0) / torch.sum(m)

    def quad(a, b):
        return torch.sum(local[:, a] * local[:, b] * charges
                         + local[:, a] * mu[:, b] + local[:, b] * mu[:, a])

    xx, yy, zz = quad(0, 0), quad(1, 1), quad(2, 2)
    xy, xz, yz = quad(0, 1), quad(0, 2), quad(1, 2)
    qave = (xx + yy + zz) / 3.0
    debye = 4.80321
    q = torch.stack([0.5 * (xx - qave), 0.5 * xy, 0.5 * xz,
                     0.5 * xy, 0.5 * (yy - qave), 0.5 * yz,
                     0.5 * xz, 0.5 * yz, 0.5 * (zz - qave)]) * (100.0 * 3.0 * debye)
    dpl = torch.sum(local * charges[:, None] + mu, dim=0) * (10.0 * debye)
    return torch.cat([torch.sum(charges)[None], dpl, q])


def electrostatic_potential_on_grid(params: ElecParams, positions, grid_points):
    """Potential (kJ/mol/e) at grid_points [G, 3] (nm) from the charges and
    the converged induced dipoles, undamped: [G]."""
    _, _, diag = cluster_electrostatics(params, positions)
    charges, mu = diag['charges'], diag['induced_dipoles']
    delta = positions[None, :, :] - grid_points[:, None, :]      # site - grid point
    r2 = torch.sum(delta * delta, dim=-1)
    r = torch.sqrt(r2)
    pot = charges[None, :] / r - torch.einsum('jd,gjd->gj', mu, delta) / (r2 * r)
    return units.ELECTRIC * torch.sum(pot, dim=1)
