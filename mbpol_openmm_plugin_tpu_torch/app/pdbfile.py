"""PDB reading/writing + a lightweight Topology (port of
mbpol_openmm_plugin_tpu/app/pdbfile.py).

Replaces OpenMM's app.PDBFile for the water(+Cl-) systems the reference
supports. Handles the fixture conventions of the reference test-suite
(HETATM records, HOH residues ordered O,H1,H2,M, optional Cl residues,
CRYST1 box records). Everything here is host-side: positions are numpy
arrays in nm, and a reporter reads the card's tensors only through the
State it is handed at report time.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from mbpol_openmm_plugin_tpu_torch.app import units_compat as unit


@dataclasses.dataclass
class Atom:
    index: int
    name: str
    residue_name: str
    residue_index: int


class Topology:
    def __init__(self, atoms: List[Atom], box=None):
        self.atoms_list = atoms
        self._box = None if box is None else np.asarray(box, float)

    def atoms(self):
        return iter(self.atoms_list)

    def getNumAtoms(self):
        return len(self.atoms_list)

    def setUnitCellDimensions(self, dims):
        if isinstance(dims, unit.Quantity):
            self._box = np.asarray(dims.to_internal(), float)
        else:
            self._box = np.asarray([float(d) for d in dims], float)

    def getUnitCellDimensions(self):
        return self._box

    @property
    def atom_names(self):
        return [a.name for a in self.atoms_list]

    @property
    def residue_names(self):
        return [a.residue_name for a in self.atoms_list]


class PDBFile:
    """Reads HETATM/ATOM records; positions exposed in nm (Quantity)."""

    def __init__(self, filename):
        names, resnames, resids, pos = [], [], [], []
        box = None
        with open(filename) as f:
            for line in f:
                if line.startswith(('ATOM', 'HETATM')):
                    names.append(line[12:16].strip())
                    resnames.append(line[17:21].strip())
                    resids.append(int(line[22:26]))
                    pos.append([float(line[30:38]), float(line[38:46]), float(line[46:54])])
                elif line.startswith('CRYST1'):
                    box = [float(line[6:15]) * 0.1, float(line[15:24]) * 0.1,
                           float(line[24:33]) * 0.1]
        atoms = [Atom(i, n, rn, ri) for i, (n, rn, ri) in
                 enumerate(zip(names, resnames, resids))]
        self.topology = Topology(atoms, box=box)
        self._positions_nm = np.asarray(pos) * 0.1
        self.positions = unit.Quantity(self._positions_nm, unit.nanometer)

    def getPositions(self, asNumpy=True):
        return self.positions


def write_pdb_frame(fh, topology: Topology, positions_nm, model_index=None):
    """Write one PDB model (positions in nm, a numpy array)."""
    if model_index is not None:
        fh.write('MODEL     %4d\n' % model_index)
    box = topology.getUnitCellDimensions()
    if box is not None and model_index in (None, 1):
        fh.write('CRYST1%9.3f%9.3f%9.3f  90.00  90.00  90.00 P 1           1\n'
                 % tuple(np.asarray(box) * 10.0))
    pos_a = np.asarray(positions_nm) * 10.0
    for atom in topology.atoms():
        name = atom.name if len(atom.name) >= 4 else ' ' + atom.name
        fh.write('HETATM%5d %-4s%4s  %4d    %8.4f%8.4f%8.4f  1.00  0.00\n'
                 % (atom.index + 1, name[:4], atom.residue_name[:4],
                    atom.residue_index, *pos_a[atom.index]))
    if model_index is not None:
        fh.write('ENDMDL\n')


class PDBReporter:
    """Trajectory reporter writing PDB MODEL frames every `interval` steps."""

    def __init__(self, filename, interval):
        self.filename = filename
        self.reportInterval = int(interval)
        self._fh = None
        self._model = 0

    def report(self, simulation, state):
        if self._fh is None:
            self._fh = open(self.filename, 'w')
        self._model += 1
        pos = state.getPositions().to_internal()
        write_pdb_frame(self._fh, simulation.topology, pos, self._model)
        self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
