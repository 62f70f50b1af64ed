"""System topology and geometry helpers (port of mbpol_openmm_plugin_tpu/system.py).

A `System` holds the static description (index arrays, classes, masses,
box) as numpy arrays; positions are torch tensors [natoms, 3] in nm.
Layout: each water contributes four sites [O, H1, H2, M]; monatomic ions
(Cl-) follow as single sites.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch import _data
from mbpol_openmm_plugin_tpu_torch.utils.consts import device_const

# atom class codes (order of the dispersion C6/d6 tables)
CLASS_O, CLASS_H, CLASS_M, CLASS_CL = 0, 1, 2, 3
# CODATA deuterium atomic mass (amu)
MASS_D = 2.01410177812


@dataclasses.dataclass(frozen=True)
class System:
    """Static topology of a (water + optional Cl-) system."""
    n_waters: int
    n_ions: int
    atom_class: np.ndarray          # [natoms] int32, CLASS_*
    mol_index: np.ndarray           # [natoms] int32
    masses: np.ndarray              # [natoms] float64 (amu); M sites have 0
    o_index: np.ndarray             # [n_waters] int32
    h1_index: np.ndarray
    h2_index: np.ndarray
    m_index: np.ndarray
    ion_index: np.ndarray           # [n_ions] int32
    box: Optional[np.ndarray]       # [3] nm (orthorhombic) or None

    @property
    def n_atoms(self):
        return len(self.atom_class)

    @property
    def periodic(self):
        return self.box is not None

    def with_box(self, box):
        box = None if box is None else np.asarray(box, np.float64)
        return dataclasses.replace(self, box=box)

    @classmethod
    def waters(cls, n_waters, n_ions=0, box=None, isotope='H2O'):
        """Standard layout: n_waters x [O,H1,H2,M] then n_ions x [Cl].
        isotope: 'H2O', 'D2O' or 'HDO' (H1 -> D); only the masses differ."""
        ff = _data.load('forcefield')
        m_h1 = m_h2 = float(ff['mass_H'])
        if isotope == 'D2O':
            m_h1 = m_h2 = MASS_D
        elif isotope == 'HDO':
            m_h1 = MASS_D
        elif isotope != 'H2O':
            raise ValueError(f'unknown isotope {isotope!r}')
        base = 4 * np.arange(n_waters, dtype=np.int32)
        atom_class = np.concatenate([
            np.tile([CLASS_O, CLASS_H, CLASS_H, CLASS_M], n_waters),
            np.full(n_ions, CLASS_CL)]).astype(np.int32)
        mol_index = np.concatenate([
            np.repeat(np.arange(n_waters), 4),
            n_waters + np.arange(n_ions)]).astype(np.int32)
        masses = np.concatenate([
            np.tile([ff['mass_O'], m_h1, m_h2, ff['mass_M']], n_waters),
            np.full(n_ions, ff['mass_Cl'])]).astype(np.float64)
        return cls(
            n_waters=n_waters, n_ions=n_ions,
            atom_class=atom_class, mol_index=mol_index, masses=masses,
            o_index=base, h1_index=base + 1, h2_index=base + 2, m_index=base + 3,
            ion_index=(4 * n_waters + np.arange(n_ions, dtype=np.int32)),
            box=None if box is None else np.asarray(box, np.float64))

    @classmethod
    def from_atom_names(cls, names, resnames, box=None, isotope='H2O'):
        """Build from PDB-style atom/residue names (O,H1,H2,M per HOH
        residue, optional Cl residues)."""
        names = [str(n) for n in names]
        resnames = [str(r) for r in resnames]
        n_waters = sum(1 for n, r in zip(names, resnames) if r == 'HOH' and n == 'O')
        n_ions = sum(1 for r in resnames if r in ('Cl', 'CL', 'CL-'))
        expected = [n for _ in range(n_waters) for n in ('O', 'H1', 'H2', 'M')]
        got = [n for n, r in zip(names, resnames) if r == 'HOH']
        if got != expected:
            raise ValueError('unsupported atom ordering; expected O,H1,H2,M per water')
        return cls.waters(n_waters, n_ions, box=box, isotope=isotope)


def _contiguous_waters(system: System):
    """True for the standard stride-4 OHHM block."""
    n = system.n_waters
    return bool(np.array_equal(system.o_index, 4 * np.arange(n)))


def _standard_layout(system: System):
    """True for the water-only stride-4 OHHM block: then every per-molecule
    restructuring is a reshape."""
    return system.n_ions == 0 and _contiguous_waters(system)


def compute_virtual_sites(system: System, positions):
    """Place each water's M site: weights (w1, w2, w3) over (O, H1, H2).
    Differentiable."""
    w1, w2, w3 = (float(w) for w in _data.load('forcefield')['vsite_weights'])
    if _standard_layout(system):
        p4 = positions.reshape(system.n_waters, 4, 3)
        m = w1 * p4[:, 0] + w2 * p4[:, 1] + w3 * p4[:, 2]
        return torch.cat([p4[:, :3], m[:, None]], dim=1).reshape(-1, 3)
    o, h1, h2 = (positions[index_tensor(i, positions)]
                 for i in (system.o_index, system.h1_index, system.h2_index))
    m_pos = w1 * o + w2 * h1 + w3 * h2
    return positions.index_put((index_tensor(system.m_index, positions),), m_pos)


def index_tensor(idx, like):
    """A numpy index array as an int64 tensor on `like`'s device (copied
    once, utils/consts.py)."""
    return device_const(np.asarray(idx, np.int64), device=like.device)


def water_positions(system: System, positions):
    """[n_waters, 3, 3] (O,H1,H2) position blocks (a reshape on the standard
    layout, a gather otherwise)."""
    if _contiguous_waters(system):
        return positions[:4 * system.n_waters].reshape(system.n_waters, 4, 3)[:, :3]
    return positions[index_tensor(np.stack([system.o_index, system.h1_index, system.h2_index],
                                           axis=1), positions)]


def oxygen_positions(system: System, positions):
    """[n_waters, 3] oxygen positions."""
    if _contiguous_waters(system):
        return positions[:4 * system.n_waters].reshape(system.n_waters, 4, 3)[:, 0]
    return positions[index_tensor(system.o_index, positions)]


def box_tensor(box, like):
    """The box (three floats) as a tensor in `like`'s dtype and device
    (copied once per box). A tensor box is returned as it is: the
    differentiable box of md/pressure.py."""
    if isinstance(box, torch.Tensor):
        return box
    return device_const(np.asarray(box, np.float64), dtype=like.dtype, device=like.device)


def make_molecules_whole(system: System, positions, box=None):
    """Image each water's hydrogens (and, on the standard layout, its M)
    next to its oxygen in `box` (default the system's). A no-op for whole
    molecules and non-periodic systems."""
    if not system.periodic:
        return positions
    box = box_tensor(system.box if box is None else box, positions)
    if _standard_layout(system):
        p4 = positions.reshape(system.n_waters, 4, 3)
        o = p4[:, 0:1]
        rest = p4[:, 1:] + torch.floor((o - p4[:, 1:]) / box + 0.5) * box
        return torch.cat([o, rest], dim=1).reshape(-1, 3)
    o = oxygen_positions(system, positions)
    for idx in (system.h1_index, system.h2_index):
        rows = index_tensor(idx, positions)
        p = positions[rows]
        positions = positions.index_put((rows,), p + torch.floor((o - p) / box + 0.5) * box)
    return positions


def minimum_image(delta, box):
    """Minimum-image displacement, delta -= floor(delta/box + 0.5) * box."""
    if box is None:
        return delta
    b = box_tensor(box, delta)
    return delta - torch.floor(delta / b + 0.5) * b


def replicate(system: System, positions, reps):
    """The periodic water box repeated reps = (nx, ny, nz) times along its
    axes: (System of the enlarged box, positions [nx*ny*nz*natoms, 3]).
    Copy (a, b, c), shifted by (a, b, c) * box, is the block of waters
    ((a * ny + b) * nz + c) * n_waters ... onward. Water-only layouts."""
    if not system.periodic or system.n_ions:
        raise ValueError('replicate takes a periodic water-only system')
    box = np.asarray(system.box, np.float64)
    shifts = [(a, b, c) for a in range(reps[0]) for b in range(reps[1]) for c in range(reps[2])]
    shift = torch.as_tensor(np.asarray(shifts, np.float64) * box, dtype=positions.dtype,
                            device=positions.device)
    big = System.waters(system.n_waters * len(shifts), box=box * np.asarray(reps))
    return big, (positions[None] + shift[:, None, :]).reshape(-1, 3)
