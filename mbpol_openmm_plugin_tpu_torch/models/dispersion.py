"""TT6-damped C6 dispersion, dense mode
(port of mbpol_openmm_plugin_tpu/models/dispersion.py).

Energy -C6 * tt6(d6 r) / r^6 over all site pairs of different molecules,
with per-class-pair (O,H,M,Cl) C6/d6 tables (the M rows are zero) and an
optional C2 switch of the tail. The molecule-pair ('pairs') mode is not
ported yet (see ROADMAP.md).
"""
import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch import _data
from mbpol_openmm_plugin_tpu_torch.system import System, minimum_image


def tt6(x):
    """Order-6 Tang-Toennies damping in Horner form, safe at x = 0."""
    s = 1.0 / 720.0
    for k in (120.0, 24.0, 6.0, 2.0, 1.0, 1.0):
        s = s * x + 1.0 / k
    return 1.0 - torch.exp(-x) * s


def switch_factor(r2, cutoff, width):
    """OpenMM CustomNonbondedForce switch S(x) = 1 - 10x^3 + 15x^4 - 6x^5
    over [cutoff - width, cutoff]. width = 0 is the reference's plain
    truncation, a discontinuous force field at the cutoff sphere."""
    x = (torch.sqrt(r2) - (cutoff - width)) / width
    x = torch.clamp(x, 0.0, 1.0)
    return 1.0 - x * x * x * (10.0 + x * (-15.0 + 6.0 * x))


def dispersion_energy(system: System, positions, cutoff=None, switch_width=0.0):
    """Total dispersion energy in kJ/mol over the dense [N, N] site grid.
    positions: [natoms, 3] nm with M sites placed."""
    ff = _data.load('forcefield')
    dt, dev = positions.dtype, positions.device
    cls = torch.as_tensor(np.asarray(system.atom_class, np.int64), device=dev)
    C6 = torch.as_tensor(ff['C6'], dtype=dt, device=dev)[cls][:, cls]
    d6 = torch.as_tensor(ff['d6'], dtype=dt, device=dev)[cls][:, cls]
    mol = torch.as_tensor(np.asarray(system.mol_index, np.int64), device=dev)

    delta = minimum_image(positions[None, :, :] - positions[:, None, :],
                          system.box if system.periodic else None)
    r2 = torch.sum(delta * delta, dim=-1)

    mask = mol[:, None] != mol[None, :]
    if cutoff is not None:
        mask = mask & (r2 < cutoff * cutoff)

    r2 = torch.where(mask, r2, 1.0)           # avoid 0/0 on the diagonal
    r = torch.sqrt(r2)
    e_pair = -C6 * tt6(d6 * r) / (r2 * r2 * r2)
    if cutoff is not None and switch_width > 0.0:
        e_pair = e_pair * switch_factor(r2, cutoff, switch_width)
    return 0.5 * torch.sum(torch.where(mask, e_pair, 0.0))
