"""app.Simulation-compatible driver over the port's MD engine (port of
mbpol_openmm_plugin_tpu/app/simulation.py).

A Simulation runs on the card unless its `platform` asks for the CPU:
platform None or 'CUDA' (or `Platform.getPlatformByName('CUDA')`) builds
the potential on the card in float32, 'CPU' on the CPU in float64, as the
port's MBPol does; without a card the default raises, nothing falls back.
The state stays on the potential's device: State, StateDataReporter and
the trajectory reporters read it on the host only when a report is made.
"""
from __future__ import annotations

import dataclasses
import time
import types

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch.app import units_compat as unit
from mbpol_openmm_plugin_tpu_torch.app.forcefield import SystemSpec, _Force
from mbpol_openmm_plugin_tpu_torch.md import integrators as I
from mbpol_openmm_plugin_tpu_torch.md import pressure as _pr
from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation as CoreSimulation
from mbpol_openmm_plugin_tpu_torch.md.simulation import SimulationConfig
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.system import compute_virtual_sites


class Platform:
    """OpenMM's Platform role: where a Simulation evaluates. 'CUDA' is the
    card (float32), 'CPU' the host (float64); any other name raises."""
    DEVICES = {'CUDA': 'cuda', 'CPU': 'cpu'}

    def __init__(self, name):
        if name not in self.DEVICES:
            raise ValueError(f'unknown platform {name!r}; the port runs on '
                             f'{" or ".join(self.DEVICES)}')
        self._name = name

    def getName(self):
        return self._name

    @property
    def device(self):
        return self.DEVICES[self._name]

    @staticmethod
    def getPlatformByName(name):
        return Platform(name)


def _platform_device(platform):
    """The torch device name of a Simulation's `platform` argument: None
    (the card), a platform name or a Platform."""
    if platform is None:
        return Platform.DEVICES['CUDA']
    if isinstance(platform, str):
        platform = Platform(platform)
    if not isinstance(platform, Platform):
        raise TypeError(f'platform must be None, a name or a Platform, got {platform!r}')
    return platform.device


def _host(x):
    """A tensor (on any device) or an array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return np.array(x.detach().cpu().numpy())     # a copy, never a view of the state
    return np.asarray(x)


class VerletIntegrator:
    def __init__(self, stepSize):
        self.dt = float(unit.to_internal(stepSize, unit.picosecond))


class LangevinIntegrator:
    def __init__(self, temperature, frictionCoeff, stepSize):
        self.temperature = float(unit.to_internal(temperature, unit.kelvin))
        self.friction = float(unit.to_internal(frictionCoeff))
        self.dt = float(unit.to_internal(stepSize, unit.picosecond))


class MTSVerletIntegrator(VerletIntegrator):
    """OpenMM MTSIntegrator role (r-RESPA): stepSize is the OUTER step for
    the expensive intermolecular terms; the Partridge-Schwenke monomer term
    integrates at stepSize/innerSteps (md/integrators.respa_velocity_verlet_step).

    midSteps > 1 selects the THREE-level ladder
    (md/integrators.respa3_velocity_verlet_step): the three-body PIP alone
    kicks at stepSize, the remaining intermolecular terms at
    stepSize/midSteps, the monomer term at stepSize/(midSteps*innerSteps)."""

    def __init__(self, stepSize, innerSteps=2, midSteps=1):
        super().__init__(stepSize)
        self.respa_inner = int(innerSteps)
        self.respa_mid = int(midSteps)


class MTSLangevinIntegrator(LangevinIntegrator):
    """OpenMM MTSLangevinIntegrator role: BAOAB-RESPA (the O-step runs per
    inner sub-step; outer half-kicks carry the slow forces)."""

    def __init__(self, temperature, frictionCoeff, stepSize, innerSteps=2):
        super().__init__(temperature, frictionCoeff, stepSize)
        self.respa_inner = int(innerSteps)


class AndersenThermostat(_Force):
    def __init__(self, temperature, collisionFrequency):
        super().__init__('andersen_thermostat',
                         temperature=float(unit.to_internal(temperature, unit.kelvin)),
                         frequency=float(unit.to_internal(collisionFrequency)))


class MonteCarloBarostat(_Force):
    def __init__(self, pressure, temperature, frequency=25):
        super().__init__('mc_barostat',
                         pressure=float(unit.to_internal(pressure, unit.bar)),
                         temperature=float(unit.to_internal(temperature, unit.kelvin)),
                         frequency=int(frequency))


class State:
    """A snapshot: tensors on the potential's device (or numpy arrays), read
    on the host when a getter is called."""

    def __init__(self, positions_nm, velocities, forces, potential_energy,
                 kinetic_energy, box):
        self._pos = positions_nm
        self._vel = velocities
        self._forces = forces
        self._pe = potential_energy
        self._ke = kinetic_energy
        self._box = box

    def getPositions(self, asNumpy=True):
        return unit.Quantity(_host(self._pos), unit.nanometer)

    def getVelocities(self, asNumpy=True):
        return unit.Quantity(_host(self._vel), unit.nanometer_per_picosecond)

    def getForces(self, asNumpy=True):
        return unit.Quantity(_host(self._forces), unit.kilojoule_per_mole / unit.nanometer)

    def getPotentialEnergy(self):
        return unit.Quantity(float(self._pe), unit.kilojoule_per_mole)

    def getKineticEnergy(self):
        return unit.Quantity(float(self._ke), unit.kilojoule_per_mole)

    def getPeriodicBoxVolume(self):
        vol = 0.0 if self._box is None else float(np.prod(np.asarray(self._box)))
        return unit.Quantity(vol, unit.nanometer ** 3)


class Context:
    def __init__(self, simulation):
        self._sim = simulation

    def setPositions(self, positions):
        if isinstance(positions, unit.Quantity):
            pos = np.asarray(positions.to_internal())
        else:
            pos = np.asarray([[float(c) for c in p] for p in positions])
        self._sim._core.set_positions(pos)

    def computeVirtualSites(self):
        # virtual sites are recomputed inside every energy evaluation; nothing
        # to do, kept for API parity.
        pass

    def applyConstraints(self, tol):
        pass

    def setVelocitiesToTemperature(self, temperature):
        self._sim._core.set_velocities_to_temperature(
            float(unit.to_internal(temperature, unit.kelvin)))

    def setVelocities(self, velocities):
        v = (velocities.to_internal() if isinstance(velocities, unit.Quantity)
             else np.asarray(velocities))
        core = self._sim._core
        core.state = dataclasses.replace(core.state,
                                         velocities=core.potential.as_positions(v))

    def getState(self, getPositions=False, getVelocities=False, getForces=False,
                 getEnergy=False, **kw):
        core = self._sim._core
        st = core.state
        ke = I.kinetic_energy(core.system, st.velocities)
        # Virtual M-sites carry zero mass, so the integrator never moves
        # them; place them (on the potential's device) so reported and
        # written positions are current.
        return State(compute_virtual_sites(core.system, st.positions), st.velocities,
                     st.forces, st.potential_energy, ke, st.box)


class StateDataReporter:
    def __init__(self, file, reportInterval, step=False, time=False,
                 potentialEnergy=False, kineticEnergy=False, totalEnergy=False,
                 temperature=False, volume=False, density=False, progress=False,
                 remainingTime=False, speed=False, pressure=False,
                 totalSteps=1, separator=','):
        # pressure= is a superset of OpenMM's StateDataReporter surface:
        # the instantaneous molecular virial pressure (bar) from
        # md/pressure.py (dU/dlambda by autograd). Costs roughly one extra
        # potential evaluation per report; periodic systems only.
        self._file = file
        self.reportInterval = int(reportInterval)
        self._opts = dict(step=step, time=time, potentialEnergy=potentialEnergy,
                          kineticEnergy=kineticEnergy, totalEnergy=totalEnergy,
                          temperature=temperature, volume=volume, density=density,
                          progress=progress, remainingTime=remainingTime,
                          speed=speed, pressure=pressure)
        self.totalSteps = totalSteps
        self.sep = separator
        self._fh = None
        self._wrote_header = False
        self._t0 = None

    def _open(self):
        if self._fh is None:
            self._fh = self._file if hasattr(self._file, 'write') else open(self._file, 'w')

    def report(self, simulation, state):
        self._open()
        core = simulation._core
        o = self._opts
        step = int(core.state.step)
        if self._t0 is None:
            self._t0 = (time.time(), step)
        headers, values = [], []
        if o['progress']:
            headers.append('Progress (%)')
            values.append('%.1f' % (100.0 * step / max(self.totalSteps, 1)))
        if o['step']:
            headers.append('Step')
            values.append(str(step))
        if o['time']:
            headers.append('Time (ps)')
            values.append('%.4f' % (step * simulation._dt))
        pe = float(core.state.potential_energy)
        ke = float(I.kinetic_energy(core.system, core.state.velocities))
        if o['potentialEnergy']:
            headers.append('Potential Energy (kJ/mole)')
            values.append('%.4f' % pe)
        if o['kineticEnergy']:
            headers.append('Kinetic Energy (kJ/mole)')
            values.append('%.4f' % ke)
        if o['totalEnergy']:
            headers.append('Total Energy (kJ/mole)')
            values.append('%.4f' % (pe + ke))
        if o['temperature']:
            headers.append('Temperature (K)')
            values.append('%.2f' % float(I.temperature(core.system, core.state.velocities)))
        if o['volume'] or o['density']:
            box = core.state.box
            vol = (float(np.prod(np.asarray(box))) if box is not None else 0.0) or np.nan
            if o['volume']:
                headers.append('Box Volume (nm^3)')
                values.append('%.4f' % vol)
            if o['density']:
                mass = float(np.sum(core.system.masses))  # amu
                headers.append('Density (g/mL)')
                values.append('%.5f' % (mass / vol * 1.66053906660e-3))
        if o['pressure']:
            headers.append('Pressure (bar)')
            values.append('%.2f' % float(_pr.virial_pressure(
                core.potential, core.state.positions,
                velocities=core.state.velocities, box=core.state.box)))
        if o['speed']:
            headers.append('Speed (ns/day)')
            el = time.time() - self._t0[0]
            steps_done = step - self._t0[1]
            values.append('%.3g' % (steps_done * simulation._dt * 86.4 / el if el > 0 else 0))
        if o['remainingTime']:
            headers.append('Time Remaining')
            el = time.time() - self._t0[0]
            steps_done = max(step - self._t0[1], 1)
            rem = el / steps_done * max(self.totalSteps - step, 0)
            values.append('%d:%02d' % (int(rem // 60), int(rem % 60)))
        if not self._wrote_header:
            self._fh.write('#"' + ('"%s"' % self.sep).join(headers) + '"\n')
            self._wrote_header = True
        self._fh.write(self.sep.join(values) + '\n')
        self._fh.flush()


class PIMDCentroidWriter:
    """Adapts a classical trajectory reporter (PDBReporter / NetCDFReporter)
    to PIMD bead-centroid frames.

    Pass an instance as ``frame_callback`` to ``PIMDSimulation.step``: it is
    invoked at each report boundary with (step, centroid_nm, box) and calls
    the wrapped reporter's ``report`` with a duck-typed simulation/state
    pair, honoring the reporter's own ``reportInterval``. The centroid of a
    ring polymer is the quantum particle's position estimator, so the
    resulting trajectory feeds the same analysis tools as classical MD."""

    def __init__(self, reporter, topology, dt):
        self.reporter = reporter
        self.topology = topology
        self._dt = float(dt)

    def __call__(self, step, centroid_nm, box):
        interval = getattr(self.reporter, 'reportInterval', 1)
        if interval > 1 and step % interval:
            return
        z = np.zeros_like(centroid_nm)
        state = State(centroid_nm, z, z, 0.0, 0.0, box)
        core = types.SimpleNamespace(
            state=types.SimpleNamespace(step=step, box=box),
            system=None)
        sim = types.SimpleNamespace(topology=self.topology, _core=core,
                                    _dt=self._dt)
        self.reporter.report(sim, state)


# The adapter is frame-source agnostic (it only needs (step, positions,
# box)); the generic name serves REMD cold-slot trajectories and any
# other per-frame callback source.
TrajectoryFrameWriter = PIMDCentroidWriter


class LocalEnergyMinimizer:
    """OpenMM LocalEnergyMinimizer surface: L-BFGS on the potential's device
    (md/minimize.py). tolerance is the RMS-force target in kJ/mol/nm."""

    @staticmethod
    def minimize(context, tolerance=10.0, maxIterations=200):
        context._sim._core.minimize_energy(max_iterations=maxIterations,
                                           tolerance=tolerance)


class Simulation:
    def __init__(self, topology, system: SystemSpec, integrator, platform=None,
                 seed=0):
        self.topology = topology
        self.spec = system
        self.reporters = []

        thermo = system.find_forces('andersen_thermostat')
        baro = system.find_forces('mc_barostat')
        if isinstance(integrator, LangevinIntegrator):
            cfg = SimulationConfig(dt=integrator.dt, temperature=integrator.temperature,
                                   thermostat='langevin', friction=integrator.friction)
        elif thermo:
            p = thermo[0].params
            cfg = SimulationConfig(dt=integrator.dt, temperature=p['temperature'],
                                   thermostat='andersen',
                                   collision_frequency=p['frequency'])
        else:
            cfg = SimulationConfig(dt=integrator.dt, temperature=None)
        if baro:
            cfg.barostat_pressure = baro[0].params['pressure']
            cfg.barostat_interval = baro[0].params['frequency']
        cfg.respa_inner = getattr(integrator, 'respa_inner', 1)
        cfg.respa_mid = getattr(integrator, 'respa_mid', 1)
        if system.find_forces('cm_motion'):
            cfg.cm_motion_interval = 1     # OpenMM CMMotionRemover default
        self._dt = integrator.dt

        mb_cfg = MBPolConfig(
            nonbonded_method=system.nonbonded_method,
            cutoff=system.cutoff,
            cutoff_2b=system.cutoff_2b, cutoff_3b=system.cutoff_3b,
            include_charge_redistribution=system.include_charge_redistribution,
            ewald_error_tolerance=system.ewald_error_tolerance,
            thole=None if system.thole is None else tuple(system.thole),
            terms=system.term_names)
        self.potential = MBPol(system.system, mb_cfg, device=_platform_device(platform))
        self._core = CoreSimulation(self.potential, cfg, seed=seed)
        self.context = Context(self)

    def step(self, n_steps):
        if n_steps <= 0:
            return
        done = 0
        while done < n_steps:
            # advance to the nearest absolute report boundary (OpenMM's
            # describeNextReport countdown semantics: a reporter with
            # interval k fires at global steps k, 2k, ... even when prior
            # equilibration left the counter off the grid)
            step = int(self._core.state.step)
            to_next = [r.reportInterval - step % r.reportInterval
                       for r in self.reporters if hasattr(r, 'reportInterval')]
            chunk = min(to_next + [n_steps - done])
            self._core.step(chunk)
            done += chunk
            state = self.context.getState(getEnergy=True, getPositions=True)
            for r in self.reporters:
                if int(self._core.state.step) % r.reportInterval == 0:
                    r.report(self, state)

    def minimizeEnergy(self, tolerance=None, maxIterations=200):
        self._core.minimize_energy(
            max_iterations=maxIterations,
            tolerance=10.0 if tolerance is None else float(tolerance))

    def saveCheckpoint(self, path):
        self._core.save_checkpoint(path)

    def loadCheckpoint(self, path):
        self._core.load_checkpoint_file(path)
