"""AMBER NetCDF trajectory reporter (port of mbpol_openmm_plugin_tpu/app/netcdf.py).

The reference's mbpol_builder attaches ParmEd's ``NetCDFReporter`` to save
coordinates/velocities/forces (python/bin/mbpol_builder:111-128:
``NetCDFReporter(name + ".nc", every, crds=True, vels=True, frcs=True)``).
This module provides the same reporter surface natively, writing the AMBER
NetCDF trajectory convention (Conventions="AMBER", ConventionVersion="1.0")
via scipy's NetCDF-3 writer — no ParmEd/netCDF4 dependency.

Units follow the AMBER convention: angstrom, angstrom/picosecond,
kilocalorie/mole/angstrom; the engine's internal nm / nm/ps / kJ/mol/nm
values are converted on write. The card's tensors are read on the host
only in `report`, through the State it is handed.
"""
from __future__ import annotations

import numpy as np

from mbpol_openmm_plugin_tpu_torch.utils import units as U

_NM_TO_A = U.NM_TO_ANGSTROM
_KJNM_TO_KCALA = U.KJ_PER_MOL_TO_KCAL_PER_MOL / U.NM_TO_ANGSTROM


class NetCDFReporter:
    """Trajectory reporter writing AMBER-convention NetCDF frames.

    Mirrors ParmEd's ``chemistry.openmm.reporters.NetCDFReporter(file,
    reportInterval, crds=True, vels=False, frcs=False)`` as used by the
    reference builder.
    """

    def __init__(self, file, reportInterval, crds=True, vels=False, frcs=False):
        if not (crds or vels or frcs):
            raise ValueError('must save at least one of coordinates, '
                             'velocities, or forces')
        self.filename = file
        self.reportInterval = int(reportInterval)
        self.crds, self.vels, self.frcs = bool(crds), bool(vels), bool(frcs)
        self._nc = None
        self._frame = 0
        self._periodic = False

    # -- file layout -------------------------------------------------------
    def _open(self, n_atoms, periodic):
        from scipy.io import netcdf_file

        nc = netcdf_file(self.filename, 'w', version=2)  # 64-bit offset
        nc.Conventions = b'AMBER'
        nc.ConventionVersion = b'1.0'
        nc.application = b'mbpol_openmm_plugin_tpu_torch'
        nc.program = b'mbpol_openmm_plugin_tpu_torch'
        nc.programVersion = b'1.1.1'
        nc.title = b'MB-pol trajectory'

        nc.createDimension('frame', None)
        nc.createDimension('spatial', 3)
        nc.createDimension('atom', int(n_atoms))

        v = nc.createVariable('spatial', 'c', ('spatial',))
        v[:] = np.array(list('xyz'), dtype='S1')
        t = nc.createVariable('time', 'f', ('frame',))
        t.units = b'picosecond'

        if self.crds:
            c = nc.createVariable('coordinates', 'f', ('frame', 'atom', 'spatial'))
            c.units = b'angstrom'
        if self.vels:
            c = nc.createVariable('velocities', 'f', ('frame', 'atom', 'spatial'))
            c.units = b'angstrom/picosecond'
        if self.frcs:
            c = nc.createVariable('forces', 'f', ('frame', 'atom', 'spatial'))
            c.units = b'kilocalorie/mole/angstrom'

        self._periodic = bool(periodic)
        if self._periodic:
            nc.createDimension('cell_spatial', 3)
            nc.createDimension('cell_angular', 3)
            nc.createDimension('label', 5)
            v = nc.createVariable('cell_spatial', 'c', ('cell_spatial',))
            v[:] = np.array(list('abc'), dtype='S1')
            v = nc.createVariable('cell_angular', 'c', ('cell_angular', 'label'))
            v[:] = np.array([list('alpha'), list('beta '), list('gamma')], dtype='S1')
            c = nc.createVariable('cell_lengths', 'd', ('frame', 'cell_spatial'))
            c.units = b'angstrom'
            c = nc.createVariable('cell_angles', 'd', ('frame', 'cell_angular'))
            c.units = b'degree'
        self._nc = nc

    # -- OpenMM reporter protocol -------------------------------------------
    def describeNextReport(self, simulation):
        step = int(simulation._core.state.step)
        steps = self.reportInterval - step % self.reportInterval
        return (steps, self.crds, self.vels, self.frcs, False)

    def report(self, simulation, state):
        pos = np.asarray(state.getPositions().to_internal())
        # a host float64 triple, or None for a cluster
        box = simulation._core.state.box
        box = np.zeros(0) if box is None else np.asarray(box, np.float64)
        if self._nc is None:
            self._open(pos.shape[0], periodic=box.size == 3 and np.all(box > 0))

        i = self._frame
        nc = self._nc
        step = int(simulation._core.state.step)
        nc.variables['time'][i] = step * getattr(simulation, '_dt', 0.0)
        if self.crds:
            nc.variables['coordinates'][i] = (pos * _NM_TO_A).astype(np.float32)
        if self.vels:
            vel = np.asarray(state.getVelocities().to_internal())
            nc.variables['velocities'][i] = (vel * _NM_TO_A).astype(np.float32)
        if self.frcs:
            frc = np.asarray(state.getForces().to_internal())
            nc.variables['forces'][i] = (frc * _KJNM_TO_KCALA).astype(np.float32)
        if self._periodic:
            nc.variables['cell_lengths'][i] = box * _NM_TO_A
            nc.variables['cell_angles'][i] = (90.0, 90.0, 90.0)
        self._frame += 1
        nc.flush()

    def close(self):
        if self._nc is not None:
            self._nc.close()
            self._nc = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
