"""water14 cluster example: single-point energy and forces, minimization,
NVE (examples/water14.py through the port's app layer: the reference
driver python/water14.py with the imports swapped).

    python -m mbpol_openmm_plugin_tpu_torch.examples.water14 [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from mbpol_openmm_plugin_tpu_torch.examples import _common
from mbpol_openmm_plugin_tpu_torch.utils import cli


def run(device='cuda', min_iterations=100, nve_steps=100, pdb_dir=None, echo=True):
    """The script's readings: the single point (kcal/mol) and forces
    (kcal/mol/A), the energy after minimization and after the NVE steps."""
    from mbpol_openmm_plugin_tpu_torch import app
    from mbpol_openmm_plugin_tpu_torch.app import unit
    say = print if echo else (lambda *a, **k: None)
    dev = cli.device(device)

    pdb = app.PDBFile(_common.pdb_path('water14_cluster', pdb_dir))
    forcefield = app.ForceField(app.mbpol_xml_path())
    system = forcefield.createSystem(pdb.topology, nonbondedMethod=app.CutoffNonPeriodic,
                                     nonbondedCutoff=1e3 * unit.nanometer)
    integrator = app.VerletIntegrator(0.2 * unit.femtoseconds)
    simulation = app.Simulation(pdb.topology, system, integrator,
                                platform=_common.platform(dev))
    simulation.context.setPositions(pdb.positions)
    simulation.context.computeVirtualSites()

    state = simulation.context.getState(getForces=True, getEnergy=True)
    e0 = state.getPotentialEnergy().value_in_unit(unit.kilocalorie_per_mole)
    say('Potential energy:', e0, 'kcal/mol')
    kcal_a = unit.kilocalorie_per_mole / unit.angstrom
    forces = np.asarray([f.value_in_unit(kcal_a) for f in state.getForces()])
    for f in forces:
        say(f)

    say('Minimizing...')
    simulation.minimizeEnergy(maxIterations=min_iterations)
    state = simulation.context.getState(getEnergy=True)
    e_min = state.getPotentialEnergy().value_in_unit(unit.kilocalorie_per_mole)
    say('After minimization:', e_min, 'kcal/mol')

    say('Short NVE run...')
    simulation.context.setVelocitiesToTemperature(300 * unit.kelvin)
    simulation.step(nve_steps)
    state = simulation.context.getState(getEnergy=True)
    e_final = state.getPotentialEnergy().value_in_unit(unit.kilocalorie_per_mole)
    say('Final PE:', e_final)
    return dict(potential_energy_kcal=e0, forces_kcal_per_A=forces,
                minimized_kcal=e_min, final_pe_kcal=e_final)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    cli.add_device_argument(ap)
    a = ap.parse_args(argv)
    run(a.device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
