"""One-body term: Partridge-Schwenke water monomer PES
(port of mbpol_openmm_plugin_tpu/models/one_body.py).

245-term polynomial in (x1, x2, x3) = ((rOH1-re)/re, (rOH2-re)/re,
cos(theta) - cos(theta_e)), symmetrized in x1 <-> x2 and damped by a
Gaussian in the OH displacements, plus Morse-like OH and H-H terms. Forces
come from autograd of this energy.
"""
import functools

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch import _data
from mbpol_openmm_plugin_tpu_torch.utils import units
from mbpol_openmm_plugin_tpu_torch.utils.consts import device_const

# scaling factors for the contributions to the empirical potential
_F5Z = 0.999677885
_FBASIS = 0.15860145369897
_FCORE = -1.6351695982132
_FREST = 1.0
_COSTHE = -0.24780227221366464506
_ENERGY_CORRECTION_CM1 = 0.44739574026257

_MAX_POW = 15   # powers x^0 .. x^14


@functools.lru_cache(maxsize=None)
def _tables():
    d = _data.load('onebody')
    c5z = (_F5Z * d['c5zA'] + _FBASIS * d['cbasis'] +
           _FCORE * d['ccore'] + _FREST * d['crest'])
    def onehot(idx):
        # power p = idx - 1 (fmat[i][n] == x^(n-1)); selecting powers by a
        # one-hot matmul keeps the backward a (deterministic) GEMM
        m = np.zeros((len(idx), _MAX_POW))
        m[np.arange(len(idx)), idx - 1] = 1.0
        return m

    t = dict(
        c5z0=float(c5z[0]),
        c5z=c5z[1:].astype(np.float64),       # terms j = 1..244
        A1=onehot(d['idx1'][1:]), A2=onehot(d['idx2'][1:]), A3=onehot(d['idx3'][1:]),
    )
    t.update({k: float(d[k]) for k in
              ['reoh', 'b1', 'roh', 'alphaoh', 'deohA', 'phh1A', 'phh2', 'cm1_kcalmol']})
    return t


def vander(x, n=_MAX_POW):
    """[batch, n] powers x^0..x^(n-1) by iterated multiplication. NOT
    x ** arange(n): the power-rule gradient of the x^0 column is
    0 * x**(-1) = NaN exactly at x == 0, and x1/x2 cross zero every OH
    vibration period."""
    cols = [torch.ones_like(x)]
    for _ in range(n - 1):
        cols.append(cols[-1] * x)
    return torch.stack(cols, dim=-1)


def one_body_energy(pos_ohh):
    """Monomer distortion energy.

    pos_ohh: [nmol, 3, 3] positions in nm, per molecule [O, H1, H2].
    Returns [nmol] energies in kJ/mol.
    """
    t = _tables()
    dev, dt = pos_ohh.device, pos_ohh.dtype
    o, h1, h2 = pos_ohh[:, 0], pos_ohh[:, 1], pos_ohh[:, 2]
    roh1 = (h1 - o) * units.NM_TO_ANGSTROM
    roh2 = (h2 - o) * units.NM_TO_ANGSTROM
    rhh = (h1 - h2) * units.NM_TO_ANGSTROM
    d1 = torch.linalg.norm(roh1, dim=-1)
    d2 = torch.linalg.norm(roh2, dim=-1)
    dhh = torch.linalg.norm(rhh, dim=-1)
    costh = torch.sum(roh1 * roh2, dim=-1) / (d1 * d2)

    deoh = _F5Z * t['deohA']
    phh1 = _F5Z * t['phh1A'] * np.exp(t['phh2'])

    exp1 = torch.exp(-t['alphaoh'] * (d1 - t['roh']))
    exp2 = torch.exp(-t['alphaoh'] * (d2 - t['roh']))
    va = deoh * (exp1 * (exp1 - 2.0) + exp2 * (exp2 - 2.0))
    vb = phh1 * torch.exp(-t['phh2'] * dhh)

    x1 = (d1 - t['reoh']) / t['reoh']
    x2 = (d2 - t['reoh']) / t['reoh']
    x3 = costh - _COSTHE
    v1, v2, v3 = vander(x1), vander(x2), vander(x3)

    A1, A2, A3 = (device_const(t[k], dtype=dt, device=dev) for k in ('A1', 'A2', 'A3'))
    p11 = v1 @ A1.T        # x1^(idx1-1)  [nmol, 244]
    p22 = v2 @ A2.T
    p12 = v1 @ A2.T        # symmetrized partner
    p21 = v2 @ A1.T
    p3 = v3 @ A3.T
    c5z = device_const(t['c5z'], dtype=dt, device=dev)
    sum0 = ((p11 * p22 + p12 * p21) * p3) @ c5z

    efac = torch.exp(-t['b1'] * ((d1 - t['reoh']) ** 2 + (d2 - t['reoh']) ** 2))
    vc = 2.0 * t['c5z0'] + efac * sum0

    e_cm1 = va + vb + vc + _ENERGY_CORRECTION_CM1
    return e_cm1 * t['cm1_kcalmol'] * units.KCAL_PER_MOL_TO_KJ_PER_MOL
