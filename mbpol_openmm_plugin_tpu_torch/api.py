"""Low-level Force API, mirroring the reference's `mbpolplugin` SWIG module
(port of mbpol_openmm_plugin_tpu/api.py).

The reference exposes four Force classes (openmmapi/include/openmm/
MBPol*Force.h) consumed either through the force-field layer or directly
(as the C++/Python tests do). This module reproduces that surface - the
parameter-container semantics plus direct evaluation helpers - on top of
the port's term functions. Example:

    from mbpol_openmm_plugin_tpu_torch import api
    force = api.MBPolElectrostaticsForce()            # on the card; device='cpu' for the CPU
    for ... : force.addElectrostatics(charge, molecule, atom_type, damping, polarizability)
    force.setTholeParameters([0.4, 0.4, 0.055, 0.626, 0.055])
    e, f = force.computeForceAndEnergy(positions_nm)

Each Force evaluates on its `device` (default 'cuda', float32; 'cpu' in
float64, as MBPol): positions are moved there, the energy and forces come
back as a float and a numpy array. The smooth terms' forces come from
torch.autograd; the electrostatics forces are explicit, and under PME its
direct space runs the K1/K2 kernels on the card (models/pme.py). Without a
card the default device raises; nothing falls back.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch import _data
from mbpol_openmm_plugin_tpu_torch.models import electrostatics as E
from mbpol_openmm_plugin_tpu_torch.models import pme as P
from mbpol_openmm_plugin_tpu_torch.models.one_body import one_body_energy
from mbpol_openmm_plugin_tpu_torch.models.three_body import (_image_triplet,
                                                              three_body_energy_triplets)
from mbpol_openmm_plugin_tpu_torch.models.two_body import _image_pair, two_body_energy_pairs
from mbpol_openmm_plugin_tpu_torch.system import box_tensor
from mbpol_openmm_plugin_tpu_torch.utils import units
from mbpol_openmm_plugin_tpu_torch.utils.consts import device_const

NoCutoff = 0
PME = 1
CutoffPeriodic = 2
CutoffNonPeriodic = 3


class _Device:
    """The device and dtype a Force evaluates on: float32 on a card, float64
    on the CPU; the default device without a card raises."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(f"{type(self).__name__}: no CUDA device is available; pass "
                               "device='cpu' to evaluate on the CPU")
        self.dtype = torch.float32 if self.device.type == 'cuda' else torch.float64

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def _energy_and_forces(self, total, positions):
        """(energy, forces as numpy) of a scalar function of the positions
        by autograd."""
        p = self._tensor(positions).detach().requires_grad_(True)
        with torch.enable_grad():
            e = total(p)
            g, = torch.autograd.grad(e, p)
        return float(e.detach()), -g.detach().cpu().numpy()


class _TripletForce(_Device):
    """Shared container for per-molecule [O, H1, H2] index triplets."""

    def __init__(self, device='cuda'):
        super().__init__(device)
        self._molecules = []
        self._nonbonded_method = NoCutoff
        self._cutoff = 1.0e10
        self._box = None

    def setNonbondedMethod(self, method):
        self._nonbonded_method = method

    def getNonbondedMethod(self):
        return self._nonbonded_method

    def setCutoff(self, cutoff):
        self._cutoff = float(cutoff)

    def getCutoff(self):
        return self._cutoff

    def setPeriodicBox(self, box):
        self._box = np.asarray(box, float)

    def getNumMolecules(self):
        return len(self._molecules)

    def _gather(self, positions):
        """[nmol, 3, 3] position blocks of the molecules' index triplets."""
        idx = device_const(np.asarray(self._molecules, np.int64), device=positions.device)
        return positions[idx]

    def _imaged(self):
        return self._nonbonded_method == CutoffPeriodic and self._box is not None

    def _box_angstrom(self, like):
        return box_tensor(self._box, like) * units.NM_TO_ANGSTROM


class MBPolOneBodyForce(_TripletForce):
    NonPeriodic, Periodic = 0, 1

    def addOneBody(self, particle_indices):
        self._molecules.append(list(particle_indices))
        return len(self._molecules) - 1

    def getOneBodyParameters(self, index):
        return list(self._molecules[index])

    def setOneBodyParameters(self, index, particle_indices):
        self._molecules[index] = list(particle_indices)

    def computeForceAndEnergy(self, positions):
        """positions [natoms,3] nm -> (energy kJ/mol, forces kJ/mol/nm)."""
        return self._energy_and_forces(lambda p: torch.sum(one_body_energy(self._gather(p))),
                                       positions)


class MBPolTwoBodyForce(_TripletForce):
    def addParticle(self, particle_indices):
        self._molecules.append(list(particle_indices))
        return len(self._molecules) - 1

    def getParticleParameters(self, index):
        return list(self._molecules[index])

    def computeForceAndEnergy(self, positions):
        ii, jj = np.triu_indices(len(self._molecules), k=1)

        def total(p):
            w = self._gather(p) * units.NM_TO_ANGSTROM
            pa, pb = w[device_const(ii, device=p.device)], w[device_const(jj, device=p.device)]
            if self._imaged():
                pa, pb = _image_pair(pa, pb, self._box_angstrom(p))
            mask = torch.ones(len(ii), dtype=torch.bool, device=p.device)
            return torch.sum(two_body_energy_pairs(pa, pb, mask)) * units.CAL_TO_JOULE

        return self._energy_and_forces(total, positions)


class MBPolThreeBodyForce(_TripletForce):
    def addParticle(self, particle_indices):
        self._molecules.append(list(particle_indices))
        return len(self._molecules) - 1

    def getParticleParameters(self, index):
        return list(self._molecules[index])

    def computeForceAndEnergy(self, positions):
        n = len(self._molecules)
        trips = np.asarray(list(itertools.combinations(range(n), 3)), np.int64).reshape(-1, 3)

        def total(p):
            w = self._gather(p) * units.NM_TO_ANGSTROM
            pa, pb, pc = (w[device_const(trips[:, k], device=p.device)] for k in range(3))
            if self._imaged():
                pa, pb, pc = _image_triplet(pa, pb, pc, self._box_angstrom(p))
            mask = torch.ones(len(trips), dtype=torch.bool, device=p.device)
            return torch.sum(three_body_energy_triplets(pa, pb, pc, mask)) * units.CAL_TO_JOULE

        return self._energy_and_forces(total, positions)


class MBPolElectrostaticsForce(_Device):
    """Parameter container + direct evaluation (cluster or PME)."""
    NoCutoff, PME = 0, 1

    def __init__(self, device='cuda'):
        super().__init__(device)
        ff = _data.load('forcefield')
        self._charges = []
        self._mols = []
        self._types = []
        self._dampings = []
        self._polarities = []
        self._method = MBPolElectrostaticsForce.NoCutoff
        self._cutoff = 0.9
        self._alpha = 0.0
        self._grid = [0, 0, 0]
        self._ewald_tol = 1e-4
        self._thole = list(ff['thole'])
        self._include_charge_redistribution = True
        self._max_iter = 200
        self._target_eps = 1e-7
        self._box = None

    # --- reference API surface (MBPolElectrostaticsForce.h) ---
    def addElectrostatics(self, charge, moleculeIndex, atomType, dampingFactor,
                          polarity):
        self._charges.append(charge)
        self._mols.append(moleculeIndex)
        self._types.append(atomType)
        self._dampings.append(dampingFactor)
        self._polarities.append(polarity)
        return len(self._charges) - 1

    def getNumElectrostatics(self):
        return len(self._charges)

    def getElectrostaticsParameters(self, i):
        return (self._charges[i], self._mols[i], self._types[i],
                self._dampings[i], self._polarities[i])

    def setElectrostaticsParameters(self, i, charge, moleculeIndex, atomType,
                                    dampingFactor, polarity):
        self._charges[i] = charge
        self._mols[i] = moleculeIndex
        self._types[i] = atomType
        self._dampings[i] = dampingFactor
        self._polarities[i] = polarity

    def setNonbondedMethod(self, m):
        self._method = m

    def getNonbondedMethod(self):
        return self._method

    def setCutoffDistance(self, c):
        self._cutoff = float(c)

    def getCutoffDistance(self):
        return self._cutoff

    def setAEwald(self, a):
        self._alpha = float(a)

    def getAEwald(self):
        return self._alpha

    def setPmeGridDimensions(self, dims):
        self._grid = list(dims)

    def getPmeGridDimensions(self):
        return list(self._grid)

    def setEwaldErrorTolerance(self, t):
        self._ewald_tol = float(t)

    def getEwaldErrorTolerance(self):
        return self._ewald_tol

    def setTholeParameters(self, thole):
        self._thole = list(thole)

    def getTholeParameters(self):
        return list(self._thole)

    def setIncludeChargeRedistribution(self, flag):
        self._include_charge_redistribution = bool(flag)

    def getIncludeChargeRedistribution(self):
        return self._include_charge_redistribution

    def setMutualInducedMaxIterations(self, n):
        self._max_iter = int(n)

    def getMutualInducedMaxIterations(self):
        return self._max_iter

    def setMutualInducedTargetEpsilon(self, e):
        self._target_eps = float(e)

    def getMutualInducedTargetEpsilon(self):
        return self._target_eps

    def setPeriodicBox(self, box):
        self._box = np.asarray(box, float)

    # --- evaluation ---
    def _params(self):
        mols = np.asarray(self._mols, np.int32)
        types = np.asarray(self._types, np.int32)
        kw = dict(
            thole=np.asarray(self._thole), damping=np.asarray(self._dampings),
            polarity=np.asarray(self._polarities), mol_index=mols,
            atom_type=types, charges=np.asarray(self._charges),
            include_charge_redistribution=self._include_charge_redistribution,
            target_epsilon=self._target_eps, max_iterations=self._max_iter)
        if self._include_charge_redistribution:
            # infer OHHM site indices per molecule from types (0=O,1=H,2=M)
            o_idx, h1_idx, h2_idx, m_idx = [], [], [], []
            for mol in range(mols.max() + 1):
                sel = np.nonzero(mols == mol)[0]
                t = types[sel]
                o_idx.append(int(sel[t == 0][0]))
                hs = sel[t == 1]
                h1_idx.append(int(hs[0]))
                h2_idx.append(int(hs[1]))
                m_idx.append(int(sel[t == 2][0]))
            kw.update(o_index=np.asarray(o_idx), h1_index=np.asarray(h1_idx),
                      h2_index=np.asarray(h2_idx), m_index=np.asarray(m_idx))
        return E.ElecParams(**kw)

    def _pme_setup(self):
        assert self._box is not None, 'setPeriodicBox required for PME'
        alpha, grid = self._alpha, self._grid
        if not alpha or not grid[0]:
            tol = self._ewald_tol
            alpha = float(np.sqrt(-np.log(2 * tol)) / self._cutoff)
            grid = [int(np.ceil(2 * alpha * b / (3 * tol ** 0.2))) for b in self._box]
        return P.PmeSetup(alpha=alpha, grid=tuple(grid), cutoff=self._cutoff,
                          box=tuple(float(b) for b in self._box))

    def computeForceAndEnergy(self, positions):
        pos = self._tensor(positions)
        params = self._params()
        with torch.no_grad():
            if self._method == MBPolElectrostaticsForce.PME:
                e, f, diag = P.pme_electrostatics(params, self._pme_setup(), pos)
            else:
                e, f, diag = E.cluster_electrostatics(params, pos)
        self._last_diag = diag
        return float(e), f.cpu().numpy()

    def getElectrostaticPotential(self, grid_points, positions):
        with torch.no_grad():
            pot = E.electrostatic_potential_on_grid(self._params(), self._tensor(positions),
                                                    self._tensor(grid_points))
        return pot.cpu().numpy()

    def getSystemElectrostaticsMoments(self, masses, positions):
        with torch.no_grad():
            mom = E.system_moments(self._params(), self._tensor(positions), np.asarray(masses))
        return mom.cpu().numpy()
