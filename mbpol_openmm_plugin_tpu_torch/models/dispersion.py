"""TT6-damped C6 dispersion, dense and molecule-pair modes
(port of mbpol_openmm_plugin_tpu/models/dispersion.py).

Energy -C6 * tt6(d6 r) / r^6 over all site pairs of different molecules,
with per-class-pair (O,H,M,Cl) C6/d6 tables (the M rows are zero) and an
optional C2 switch of the tail: over the dense [N, N] site grid
(`dispersion_energy`), or over a padded water-pair list for large boxes
(`dispersion_energy_pairs`, O(N) memory).
"""
import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch import _data
from mbpol_openmm_plugin_tpu_torch.ops.gather import gather_rows
from mbpol_openmm_plugin_tpu_torch.system import System, minimum_image, water_positions
from mbpol_openmm_plugin_tpu_torch.utils.consts import device_const

# Site-vs-oxygen offset bound for molecule-pair lists: a water's real sites
# sit within ~0.125 nm of its O even for thermally stretched OH bonds, so
# every site pair under the cutoff lives in a molecule pair with O-O
# distance under cutoff + PAIR_MARGIN.
PAIR_MARGIN = 0.25


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


def dispersion_energy(system: System, positions, cutoff=None, box=None, switch_width=0.0):
    """Total dispersion energy in kJ/mol over the dense [N, N] site grid.
    positions: [natoms, 3] nm with M sites placed; box: the periodic box
    (default the system's)."""
    ff = _data.load('forcefield')
    dt, dev = positions.dtype, positions.device
    cls = device_const(np.asarray(system.atom_class, np.int64), device=dev)
    C6 = device_const(ff['C6'], dtype=dt, device=dev)[cls][:, cls]
    d6 = device_const(ff['d6'], dtype=dt, device=dev)[cls][:, cls]
    mol = device_const(np.asarray(system.mol_index, np.int64), device=dev)

    delta = minimum_image(positions[None, :, :] - positions[:, None, :],
                          (system.box if box is None else box) if system.periodic else None)
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


def dispersion_energy_pairs(system: System, positions, mol_pairs, pair_mask, cutoff, box=None,
                            switch_width=0.0):
    """Dispersion energy in kJ/mol over a padded water-pair list
    (water-only): the same physics as `dispersion_energy`, per listed water
    pair over the 3x3 real-site block (the M rows of the tables are zero,
    so skipping M sites is exact). Exact for any list holding every water
    pair with O-O distance < cutoff + PAIR_MARGIN.

    mol_pairs: [P, 2] water indices, each unordered pair once
    (ops/neighbors.pair_list); padded entries masked by pair_mask [P]."""
    if system.n_ions:
        raise ValueError('dispersion_energy_pairs supports water-only systems')
    ff = _data.load('forcefield')
    dt, dev = positions.dtype, positions.device
    cls = np.array([0, 1, 1])                      # O, H, H class codes
    C6b = device_const(np.asarray(ff['C6'])[np.ix_(cls, cls)], dtype=dt, device=dev)
    d6b = device_const(np.asarray(ff['d6'])[np.ix_(cls, cls)], dtype=dt, device=dev)

    wflat = water_positions(system, positions).reshape(system.n_waters, 9)
    pa = gather_rows(wflat, mol_pairs[:, 0], pair_mask).reshape(-1, 3, 3)
    pb = gather_rows(wflat, mol_pairs[:, 1], pair_mask).reshape(-1, 3, 3)
    delta = minimum_image(pb[:, None, :, :] - pa[:, :, None, :],
                          system.box if box is None else box)                # [P, 3, 3, 3]
    r2 = torch.sum(delta * delta, dim=-1)

    mask = pair_mask[:, None, None] & (r2 < cutoff * cutoff)
    r2 = torch.where(mask, r2, 1.0)
    r = torch.sqrt(r2)
    e_pair = -C6b * tt6(d6b * r) / (r2 * r2 * r2)
    if switch_width > 0.0:
        e_pair = e_pair * switch_factor(r2, cutoff, switch_width)
    # each unordered molecule pair appears once: no double-count factor
    return torch.sum(torch.where(mask, e_pair, 0.0))
