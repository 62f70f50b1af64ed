"""Bulk water256 NVT -> NVE example (examples/example_nvt_nve.py through
the port's app layer): a short Andersen-thermostatted NVT segment, then an
NVE run seeded from the final NVT state, each reported to a log.

    PRODUCTION_STEPS=100 python -m mbpol_openmm_plugin_tpu_torch.examples.example_nvt_nve

writes mbpol_nvt.log and mbpol_nve.log into the current directory (or
--log-dir).
"""
from __future__ import annotations

import argparse
import os

from mbpol_openmm_plugin_tpu_torch.examples import _common
from mbpol_openmm_plugin_tpu_torch.utils import cli


def run(production_steps=100, device='cuda', log_dir='.', pdb_dir=None, echo=True):
    """The two segments; returns the logs' paths and the final state's
    potential and kinetic energy (kJ/mol) after each."""
    from mbpol_openmm_plugin_tpu_torch import app
    from mbpol_openmm_plugin_tpu_torch.app import unit
    say = print if echo else (lambda *a, **k: None)
    dev = cli.device(device)
    plat = _common.platform(dev)

    pdb = app.PDBFile(_common.pdb_path('water256_bulk', pdb_dir))
    box_dim = 19.3996888399961804 / 10.
    pdb.topology.setUnitCellDimensions((box_dim, box_dim, box_dim) * unit.nanometer)
    forcefield = app.ForceField(app.mbpol_xml_path())
    ewald_error_tolerance = 1e-4
    # the reference example's 2 fs is marginal for flexible MB-pol water
    # (OH period ~9 fs) and unstable in float32; 0.5 fs is stable
    timestep = 0.5 * unit.femtoseconds
    logs = {k: os.path.join(log_dir, f'mbpol_{k}.log') for k in ('nvt', 'nve')}

    def reporter(path):
        return app.StateDataReporter(
            path, 50, step=True, time=True, potentialEnergy=True, kineticEnergy=True,
            totalEnergy=True, temperature=True, progress=True, remainingTime=True, speed=True,
            totalSteps=production_steps, separator='\t')

    def energies(simulation):
        s = simulation.context.getState(getEnergy=True)
        return (s.getPotentialEnergy().value_in_unit(unit.kilojoule_per_mole),
                s.getKineticEnergy().value_in_unit(unit.kilojoule_per_mole))

    # ----------------------------- NVT -----------------------------
    system = forcefield.createSystem(pdb.topology, nonbondedMethod=app.PME,
                                     nonbondedCutoff=0.9 * unit.nanometers,
                                     ewaldErrorTolerance=ewald_error_tolerance)
    system.addForce(app.AndersenThermostat(300 * unit.kelvin, 1. / unit.picoseconds))
    simulation = app.Simulation(pdb.topology, system, app.VerletIntegrator(timestep),
                                platform=plat)
    simulation.context.setPositions(pdb.positions)
    simulation.context.computeVirtualSites()
    simulation.context.setVelocitiesToTemperature(300 * unit.kelvin)
    say('Equilibrating...')
    simulation.step(10)
    simulation.reporters.append(reporter(logs['nvt']))
    say('Running NVT production...')
    simulation.step(production_steps)
    nvt = energies(simulation)
    final = simulation.context.getState(getVelocities=True, getPositions=True)
    positions, velocities = final.getPositions(), final.getVelocities()

    # ----------------------------- NVE -----------------------------
    system = forcefield.createSystem(pdb.topology, nonbondedMethod=app.PME,
                                     nonbondedCutoff=0.9 * unit.nanometers,
                                     ewaldErrorTolerance=ewald_error_tolerance)
    simulation = app.Simulation(pdb.topology, system, app.VerletIntegrator(timestep),
                                platform=plat)
    simulation.context.setPositions(positions)
    simulation.context.computeVirtualSites()
    simulation.context.setVelocities(velocities)
    simulation.reporters.append(reporter(logs['nve']))
    say('Running NVE production...')
    simulation.step(production_steps)
    nve = energies(simulation)
    say('Done!')
    return dict(logs=logs, nvt_pe_ke=nvt, nve_pe_ke=nve)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--production-steps', type=int,
                    default=int(os.environ.get('PRODUCTION_STEPS', 100)))
    ap.add_argument('--log-dir', default='.')
    cli.add_device_argument(ap)
    a = ap.parse_args(argv)
    run(a.production_steps, a.device, a.log_dir)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
