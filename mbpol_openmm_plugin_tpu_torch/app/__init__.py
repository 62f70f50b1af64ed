"""OpenMM-app-compatible layer of the port (port of mbpol_openmm_plugin_tpu/app).

The reference is consumed through OpenMM's application layer
(app.PDBFile / app.ForceField / app.Simulation / reporters; see
python/water14.py, python/example_nvt_nve.py, python/bin/mbpol_builder).
This package provides the same surface on top of the port's MD engine, on
the card unless a Platform asks for the CPU:

    from mbpol_openmm_plugin_tpu_torch import app
    from mbpol_openmm_plugin_tpu_torch.app import unit

    pdb = app.PDBFile("water14_cluster.pdb")
    ff = app.ForceField(app.mbpol_xml_path())
    system = ff.createSystem(pdb.topology, nonbondedMethod=app.CutoffNonPeriodic)
    sim = app.Simulation(pdb.topology, system, app.VerletIntegrator(0.2*unit.femtoseconds))
    # on the CPU (float64): app.Simulation(..., platform=app.Platform.getPlatformByName("CPU"))
    sim.context.setPositions(pdb.positions)
    sim.context.computeVirtualSites()
    state = sim.context.getState(getEnergy=True, getForces=True)
"""
from mbpol_openmm_plugin_tpu_torch.app import units_compat as unit  # noqa: F401
from mbpol_openmm_plugin_tpu_torch.app.forcefield import (ForceField, NoCutoff,  # noqa: F401
                                                          PME, CutoffNonPeriodic,
                                                          CutoffPeriodic, mbpol_xml_path)
from mbpol_openmm_plugin_tpu_torch.app.netcdf import NetCDFReporter  # noqa: F401
from mbpol_openmm_plugin_tpu_torch.app.pdbfile import PDBFile, PDBReporter  # noqa: F401
from mbpol_openmm_plugin_tpu_torch.app.simulation import (AndersenThermostat,  # noqa: F401
                                                          LangevinIntegrator,
                                                          LocalEnergyMinimizer,
                                                          MonteCarloBarostat,
                                                          MTSLangevinIntegrator,
                                                          MTSVerletIntegrator,
                                                          PIMDCentroidWriter, Platform,
                                                          Simulation,
                                                          TrajectoryFrameWriter,
                                                          StateDataReporter,
                                                          VerletIntegrator)
