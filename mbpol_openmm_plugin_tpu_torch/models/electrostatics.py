"""Many-body polarization: parameters, Thole damping, geometry-dependent
charges and the induced-dipole SCF closures
(port of mbpol_openmm_plugin_tpu/models/electrostatics.py, PME slice).

- TTM4-F style charges from the Partridge-Schwenke dipole-moment surface,
  with their exact Jacobian dq/dr;
- MB-pol Thole damping factors of orders 1/3/5/7 (the order-1 factor uses
  the regularized incomplete gamma Q(3/4, x));
- the SOR fixed-point loop (polarSOR = 0.55) and the Kolafa ASPC
  predictor-corrector closure for MD.

Not ported yet: cluster (NoCutoff) electrostatics, DIIS, system moments
(see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch import ROADMAP_HINT, _data
from mbpol_openmm_plugin_tpu_torch.models.one_body import vander
from mbpol_openmm_plugin_tpu_torch.ops.gamma import gammq34
from mbpol_openmm_plugin_tpu_torch.utils import units

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
    scf_method: str = 'sor'      # 'sor' | 'aspc'
    aspc_k: int = 3
    aspc_n_corr: int = 1
    scf_eps_floor: Optional[float] = None
    o_index: Optional[np.ndarray] = None      # water O sites (charge redistribution)

    @classmethod
    def for_system(cls, system, **kw):
        """Parameters for a standard OHHM water System (XML values)."""
        ff = _data.load('forcefield')
        if system.n_ions:
            raise NotImplementedError('electrostatics with ions (parity with reference)')
        per_site = np.stack([ff['atom_O'], ff['atom_H'], ff['atom_H'], ff['atom_M']])
        vals = np.tile(per_site, (system.n_waters, 1))
        return cls(
            thole=ff['thole'], damping=vals[:, 1], polarity=vals[:, 2],
            mol_index=system.mol_index, atom_type=np.minimum(system.atom_class, 2),
            charges=vals[:, 0], o_index=system.o_index, **kw)


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


def assemble_charges(params: ElecParams, positions):
    """Per-site charge vector [N] and dq/dr tensors for the full system."""
    n = len(params.damping)
    if not params.include_charge_redistribution:
        return torch.as_tensor(params.charges, dtype=positions.dtype,
                               device=positions.device), None
    nmol = len(params.o_index)
    if not (np.array_equal(params.o_index, 4 * np.arange(nmol)) and 4 * nmol == n):
        raise NotImplementedError(f'non-contiguous water layouts: {ROADMAP_HINT}')
    pos_w = positions.reshape(nmol, 4, 3)[:, :3]
    q_w, dq_w = water_charges_and_derivatives(pos_w)
    zero = torch.zeros((nmol, 1), dtype=positions.dtype, device=positions.device)
    return torch.cat([zero, q_w], dim=1).reshape(-1), dq_w


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
    while True:
        dmu = efield_alpha + field_fn(mu) * alpha[:, None] - mu
        mu = mu + _POLAR_SOR * dmu
        eps = _metric(dmu, n)
        it += 1
        eps_h = float(eps)
        converged = eps_h < target_epsilon
        if converged or prev < eps_h or it >= max_iterations:
            break
        prev = eps_h
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


def make_scf(params):
    """SCF solver for params.scf_method ('sor' | 'aspc')."""
    floor = params.scf_eps_floor
    if params.scf_method == 'aspc':
        return functools.partial(scf_induced_dipoles_aspc,
                                 omega=aspc_omega(params.aspc_k),
                                 n_corr=params.aspc_n_corr, eps_floor=floor)
    if params.scf_method == 'sor':
        return functools.partial(scf_induced_dipoles, eps_floor=floor)
    if params.scf_method == 'diis':
        raise NotImplementedError(f"scf_method='diis': {ROADMAP_HINT}")
    raise ValueError(f'unknown scf_method {params.scf_method!r}')
