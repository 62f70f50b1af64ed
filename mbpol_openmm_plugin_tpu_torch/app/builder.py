"""mbpol_builder equivalent: render a runnable simulation script from an INI
(port of mbpol_openmm_plugin_tpu/app/builder.py).

Consumes the same configuration format as the reference's
python/bin/mbpol_builder (sections [system]/[integrator]/[thermostat]/
[barostat]/[logging]; see python/mbpol_config.ini and python/example_ini/),
emitting a driver script against the port's app layer: the JAX builder's
script with the port's package in every import. It runs on the card;
`--platform CPU` renders the CPU platform into the app.Simulation line (and
the device of a rebuilt potential), so the script runs on the CPU in
float64.

    python -m mbpol_openmm_plugin_tpu_torch.app.builder config.ini run.py [--platform CPU]
    python run.py
"""
from __future__ import annotations

import argparse
import configparser

from mbpol_openmm_plugin_tpu_torch.app.simulation import Platform

TEMPLATE = '''#!/usr/bin/env python
"""Generated by mbpol_openmm_plugin_tpu_torch builder from {CONFIG_NAME}."""
import sys

from mbpol_openmm_plugin_tpu_torch import app
from mbpol_openmm_plugin_tpu_torch.app import unit

simulation_name = "{SIMULATION_NAME}"
pdb = app.PDBFile("{PDB_FILENAME}")
forcefield = app.ForceField(app.mbpol_xml_path())
nonbonded = app.{NONBONDED}{PME_CONFIGURATION}

system = forcefield.createSystem(pdb.topology, nonbondedMethod=nonbonded,
    nonbondedCutoff=0.9*unit.nanometer, ewaldErrorTolerance={EWALD_ERROR_TOLERANCE}{ISOTOPE})
temperature = float({TEMPERATURE})*unit.kelvin
{THERMOSTAT}{BAROSTAT}
integrator = app.{INTEGRATOR}

simulation = app.Simulation(pdb.topology, system, integrator{PLATFORM})
simulation.context.setPositions(pdb.positions)
simulation.context.computeVirtualSites()

simulation_steps = {SIMULATION_STEPS}
equilibration_steps = {EQUILIBRATION_STEPS}

reporters = []{PDB_REPORTER}{STATE_DATA_REPORTER}
{LOCAL_MINIMIZATION}
{INTEGRATION}
'''


def _integrator_expr(config):
    """Integrator constructor expression for the rendered script: plain
    Verlet, two-level MTS (respa_inner > 1), or the three-level ladder
    (respa_mid > 1; midSteps emitted only then so two-level renders are
    unchanged)."""
    dt = config.getfloat('integrator', 'timestep_fs', fallback=1.0)
    inner = config.getint('integrator', 'respa_inner', fallback=1)
    mid = config.getint('integrator', 'respa_mid', fallback=1)
    if mid > 1:
        return ('MTSVerletIntegrator(%s*unit.femtoseconds, innerSteps=%d, '
                'midSteps=%d)' % (dt, max(inner, 1), mid))
    if inner > 1:
        return ('MTSVerletIntegrator(%s*unit.femtoseconds, innerSteps=%d)'
                % (dt, inner))
    return 'VerletIntegrator(%s*unit.femtoseconds)' % dt


def render(config_path, platform=None):
    """The driver script of an INI. platform: None (the script runs on the
    card) or a platform name ('CPU'), rendered into the app.Simulation
    line."""
    if platform is not None:
        Platform(platform)          # raises on an unknown name
    config = configparser.ConfigParser()
    config.read(config_path)
    assert 'system' in config.sections(), \
        'ERROR: The configuration file needs a [system] section'

    save_energy_every = config.getint('logging', 'save_energy_every', fallback=0)
    save_positions_every = config.getint('logging', 'save_positions_every', fallback=0)
    nonbonded = config['system']['nonbonded']

    pme_conf = ''
    if nonbonded == 'PME':
        pme_conf = ('\nboxDim = float({})\n'
                    'pdb.topology.setUnitCellDimensions((boxDim, boxDim, boxDim) * unit.nanometer)'
                    .format(config['system']['pme_box_size_nm']))

    thermostat = ''
    if 'thermostat' in config:
        thermostat = ('\nsystem.addForce(app.AndersenThermostat(temperature, '
                      'float({})/unit.picoseconds))'
                      .format(config['thermostat']['collision_rate_1overps']))
    barostat = ''
    if 'barostat' in config:
        barostat = ('\nsystem.addForce(app.MonteCarloBarostat(float({}) * unit.atmospheres, '
                    'temperature, int({})))'
                    .format(config['barostat']['pressure_atm'],
                            config['barostat']['barostat_interval']))

    pdb_rep = ''
    if save_positions_every > 0:
        pdb_rep = ('\nreporters.append(app.PDBReporter(simulation_name + '
                   '"_trajectory.pdb", {}))'.format(save_positions_every))
    sd_rep = ''
    if save_energy_every > 0:
        # [logging] save_pressure = true adds the instantaneous virial
        # pressure column (md/pressure.py; PME systems only)
        want_p = (config.getboolean('logging', 'save_pressure', fallback=False)
                  and nonbonded == 'PME')
        sd_rep = ('\nreporters.append(app.StateDataReporter(simulation_name + ".log", {}, '
                  'step=True, potentialEnergy=True, temperature=True, progress=True, '
                  'remainingTime=True, speed=True, totalEnergy=True, volume=True, '
                  'density=True, kineticEnergy=True, {}'
                  'totalSteps=max(simulation_steps+equilibration_steps, 1), '
                  "separator=','))".format(save_energy_every,
                                           'pressure=True, ' if want_p else ''))

    minimization = ''
    if config.getboolean('system', 'local_minimization', fallback=False):
        minimization = ('\nprint("Running geometry optimization")\n'
                        'simulation.minimizeEnergy(maxIterations=200)')

    save_velocities_every = config.getint('logging', 'save_velocities_every',
                                          fallback=0)
    if config.has_section('pimd') and config.has_section('remd'):
        raise SystemExit('ERROR: [pimd] and [remd] are mutually exclusive')
    if config.has_section('remd'):
        # beyond-parity extension: temperature replica exchange (md/remd.py).
        # [remd] n_replicas, t_min_k, t_max_k (geometric ladder), optional
        # exchange_interval (MD steps/swap attempt), friction_1overps.
        # [thermostat] is ignored (each replica runs BAOAB Langevin at its
        # ladder temperature); [barostat] is not supported (NVT ladder).
        if config.has_section('barostat'):
            raise SystemExit('ERROR: [remd] is an NVT ladder; remove the '
                             '[barostat] section')
        # reporters are driven by simulation.step, which REMD bypasses;
        # save_positions_every instead wires the COLD-slot trajectory
        # through the frame-callback adapter below
        pdb_rep = sd_rep = ''
        integration = '''
print("Running REMD (parallel tempering, %(R)d replicas, %(tmin)s-%(tmax)s K)")
import numpy as np
from mbpol_openmm_plugin_tpu_torch.md import remd
temps = remd.geometric_ladder(%(tmin)s, %(tmax)s, %(R)d)
cfg = remd.REMDConfig(dt=%(ts)s * 1e-3, exchange_interval=%(xint)d,
                      friction=%(fric)s%(nl_reuse)s)
pot = simulation.potential%(skin_pot)s
rx = remd.REMDSimulation(pot, temperatures=temps,
                         config=cfg, seed=1)
rx.set_positions(simulation.context.getState(getPositions=True)
                 .getPositions(asNumpy=True).value_in_unit(unit.nanometer))
rx.set_velocities_to_temperature()
# block counts round UP so at least the configured steps run
eq_blocks = -(-equilibration_steps // cfg.exchange_interval)
if eq_blocks:
    print("equilibration: %%d blocks (%%d steps)"
          %% (eq_blocks, eq_blocks * cfg.exchange_interval))
    rx.run(eq_blocks)
n_blocks = max(1, -(-simulation_steps // cfg.exchange_interval))
print("production: %%d blocks (%%d steps/replica)"
      %% (n_blocks, n_blocks * cfg.exchange_interval))%(traj)s
out = rx.run(n_blocks%(traj_kw)s)
burn = n_blocks // 4
print("slot,T_K,U_kcalmol,acceptance_to_next")
for r in range(len(temps)):
    acc = "%%.3f" %% out["acceptance"][r] if r + 1 < len(temps) else ""
    print("%%d,%%.1f,%%.4f,%%s" %% (r, temps[r],
        float(out["potential_energy"][burn:, r].mean()) / 4.184, acc))
# full per-slot PE trace (kJ/mol, one row per exchange block) - the MBAR
# input (analysis.mbar_free_energies / mbar_reweight)
np.savetxt(simulation_name + "_remd.log", out["potential_energy"],
           header="per-slot potential energy (kJ/mol) at block ends; "
                  "T_K = " + ",".join("%%.1f" %% t for t in temps))
rx.save_checkpoint(simulation_name + "_remd.npz")
print("REMD log + checkpoint written to", simulation_name + "_remd.{log,npz}")''' % dict(
            R=config.getint('remd', 'n_replicas'),
            tmin=config.getfloat('remd', 't_min_k'),
            tmax=config.getfloat('remd', 't_max_k'),
            xint=config.getint('remd', 'exchange_interval', fallback=25),
            fric=config.getfloat('remd', 'friction_1overps', fallback=1.0),
            # [remd] nlist_reuse = true: build neighbor lists once per
            # exchange block. The app layer builds its potential with
            # nlist_skin = 0 (reference semantics: exact lists every
            # step), so the reuse path needs a rebuilt potential whose
            # skin covers one block's drift.
            nl_reuse=(', nlist_reuse=True'
                      if config.getboolean('remd', 'nlist_reuse',
                                           fallback=False) else ''),
            skin_pot=('' if not config.getboolean('remd', 'nlist_reuse',
                                                  fallback=False) else '''
import dataclasses
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol
pot = MBPol(pot.system, dataclasses.replace(pot.config, nlist_skin=%s)%s)''' %
                      (config.getfloat('remd', 'nlist_skin_nm', fallback=0.02),
                       # the rebuilt potential stays on the Simulation's device
                       '' if platform is None else ', device=pot.device')),
            ts=config.getfloat('integrator', 'timestep_fs', fallback=1.0),
            # cold-slot (lowest-T) trajectory via the frame-callback
            # adapter; frames land on block boundaries, so the reporter
            # interval is rounded to a block multiple
            traj=('' if save_positions_every <= 0 else '''
frames_every = max(1, round(%d / cfg.exchange_interval)) * cfg.exchange_interval
cold_writer = app.TrajectoryFrameWriter(
    app.PDBReporter(simulation_name + "_cold_trajectory.pdb", frames_every),
    pdb.topology, cfg.dt)''' % save_positions_every),
            traj_kw=('' if save_positions_every <= 0
                     else ', frame_callback=cold_writer'))
    elif config.has_section('pimd'):
        # beyond-parity extension: ring-polymer dynamics (md/rpmd.py).
        # [pimd] n_beads, optional contraction (odd), tau0_ps,
        # bead_spread_nm; steps/timestep from [integrator]; the PILE
        # thermostat replaces [thermostat] (ignored in this mode).
        if not config['system'].get('temperature_k'):
            raise SystemExit('ERROR: [pimd] requires temperature_k in '
                             '[system] (the ring-polymer spring frequencies '
                             'are temperature-dependent)')
        integration = '''
print("Running PIMD (PILE ring-polymer dynamics, %(n_beads)d beads%(ctr_note)s)")
from mbpol_openmm_plugin_tpu_torch.md.rpmd import PIMDSimulation
pimd = PIMDSimulation(simulation.potential, n_beads=%(n_beads)d,
                      dt=%(ts)s * 1e-3, temperature=float(%(temp)s),
                      tau0=%(tau0)s, contraction=%(contraction)s, seed=1%(baro)s)
pimd.set_positions(simulation.context.getState(getPositions=True).getPositions(asNumpy=True)
                   .value_in_unit(unit.nanometer), spread=%(spread)s)
if equilibration_steps:
    pimd.step(equilibration_steps)
# save_energy_every = 0 (or no [logging]) -> one report at the end
report_every = max(1, %(report_every)d or simulation_steps)%(traj)s
metrics = pimd.step(simulation_steps, report_interval=report_every%(traj_kw)s%(press_kw)s)
press = metrics.get("pressure")
print("step,<V>_kcalmol,KE_virial_kcalmol,<E>_kcalmol"
      + (",P_bar" if press is not None else ""))
for i in range(len(metrics["step"])):
    print("%%d,%%.4f,%%.4f,%%.4f" %% (metrics["step"][i],
        metrics["potential_energy"][i] / 4.184,
        metrics["kinetic_virial"][i] / 4.184,
        metrics["total_energy"][i] / 4.184)
        + (",%%.1f" %% press[i] if press is not None else ""))
pimd.save_checkpoint(simulation_name + "_pimd.npz")
print("PIMD checkpoint written to", simulation_name + "_pimd.npz")''' % dict(
            traj=('' if save_positions_every <= 0 else '''
# centroid trajectory (the ring-polymer centroid is the quantum position
# estimator): classical PDB reporter adapted by PIMDCentroidWriter
import math
frame_cb = app.PIMDCentroidWriter(
    app.PDBReporter(simulation_name + "_centroid_trajectory.pdb", %d),
    pdb.topology, %s * 1e-3)
report_every = math.gcd(report_every, %d)''' % (
                save_positions_every,
                config.getfloat('integrator', 'timestep_fs', fallback=1.0),
                save_positions_every)),
            traj_kw=('' if save_positions_every <= 0
                     else ', frame_callback=frame_cb'),
            # [barostat] + [pimd] -> NPT ring-polymer dynamics (MC volume
            # moves on the molecule centroids; pressure_atm ~ bar here as
            # in the classical branch's MonteCarloBarostat)
            baro=('' if 'barostat' not in config else
                  (',\n                      '
                   'barostat_pressure=float(%s) * 1.01325,'  # atm -> bar
                   '\n                      barostat_interval=int(%s)') % (
                      config['barostat']['pressure_atm'],
                      config['barostat'].get('barostat_interval', '25'))),
            n_beads=config.getint('pimd', 'n_beads'),
            contraction=config.getint('pimd', 'contraction', fallback=0) or None,
            ctr_note=(', contracted to %d' %
                      config.getint('pimd', 'contraction', fallback=0)
                      if config.getint('pimd', 'contraction', fallback=0)
                      else ''),
            tau0=config.getfloat('pimd', 'tau0_ps', fallback=0.1),
            spread=config.getfloat('pimd', 'bead_spread_nm', fallback=0.002),
            report_every=save_energy_every,
            # [logging] save_pressure = true -> the quantum virial
            # pressure column (md/pressure.rpmd_virial_pressure; PME
            # only, and only uncontracted - the estimator must match the
            # sampled effective potential, see PIMDSimulation.step)
            press_kw=(', report_pressure=True'
                      if (config.getboolean('logging', 'save_pressure',
                                            fallback=False)
                          and nonbonded == 'PME'
                          and not config.getint('pimd', 'contraction',
                                                fallback=0)) else ''),
            ts=config.getfloat('integrator', 'timestep_fs', fallback=1.0),
            temp=config['system'].get('temperature_k', '0'))
    elif config.has_section('integrator'):
        nc_rep = ''
        if save_velocities_every > 0:
            nc_rep = ('reporters.append(app.NetCDFReporter(simulation_name + ".nc", '
                      '{}, crds=True, vels=True, frcs=True))\n'
                      .format(save_velocities_every))
        integration = '''
print("Setting random velocities based on temperature")
simulation.context.setVelocitiesToTemperature(temperature)

simulation.reporters.append(app.StateDataReporter(sys.stdout,
    max(1, int((simulation_steps+equilibration_steps)/10)), step=True,
    progress=True, remainingTime=True,
    totalSteps=max(simulation_steps+equilibration_steps, 1), separator=','))

print("Running equilibration")
simulation.step(equilibration_steps)
print("Running simulation")
''' + nc_rep + '''for r in reporters:
    simulation.reporters.append(r)
simulation.step(simulation_steps)'''
    else:
        integration = '''
print("Computing forces and energy")
state = simulation.context.getState(getForces=True, getEnergy=True, getPositions=True)
reporters.append(app.NetCDFReporter(simulation_name + ".nc", 1, crds=True, vels=False, frcs=True))
for r in reporters:
    r.report(simulation, state)
print("Potential energy:", state.getPotentialEnergy().value_in_unit(unit.kilocalorie_per_mole), "kcal/mol")'''

    return TEMPLATE.format(
        CONFIG_NAME=config_path,
        PDB_FILENAME=config['system']['pdb_filename'],
        SIMULATION_NAME=config['system']['simulation_name'],
        NONBONDED=nonbonded,
        PME_CONFIGURATION=pme_conf,
        EWALD_ERROR_TOLERANCE=config.getfloat('system', 'ewald_error_tolerance', fallback=1e-8),
        # [system] isotope = D2O|HDO: true isotopologue masses (PIMD-facing;
        # classically only time scales change - the PES is mass-independent)
        ISOTOPE=(', isotope="%s"' % config['system']['isotope']
                 if config['system'].get('isotope', 'H2O') != 'H2O' else ''),
        TEMPERATURE=config['system'].get('temperature_k', '0'),
        THERMOSTAT=thermostat,
        BAROSTAT=barostat,
        SIMULATION_STEPS=config.getint('integrator', 'production_steps', fallback=0),
        EQUILIBRATION_STEPS=config.getint('integrator', 'equilibration_steps', fallback=0),
        # [integrator] respa_inner = k (> 1) switches to the r-RESPA
        # multiple-timestep integrator: timestep_fs is the OUTER step for
        # the intermolecular terms, the monomer term runs at 1/k of it.
        # respa_mid = m (> 1) adds the third rung: the three-body PIP
        # alone at timestep_fs, the remaining intermolecular terms at
        # 1/m, the monomer term at 1/(m*k).
        INTEGRATOR=_integrator_expr(config),
        PDB_REPORTER=pdb_rep,
        STATE_DATA_REPORTER=sd_rep,
        LOCAL_MINIMIZATION=minimization,
        INTEGRATION=integration,
        PLATFORM=('' if platform is None else
                  ', platform=app.Platform.getPlatformByName("%s")' % platform),
    )


USAGE = 'mbpol_builder_torch configuration_filename.ini [script_filename.py] [--platform CPU]'


def main(argv=None):
    import sys
    argv = argv if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(prog='mbpol_builder_torch', usage=USAGE,
                                 description='Render a simulation script from an INI.')
    ap.add_argument('config')
    ap.add_argument('script', nargs='?')
    ap.add_argument('--platform', default=None,
                    help='CPU: render the platform into app.Simulation (default: none, the card)')
    if not argv:
        print(USAGE)
        return 1
    args = ap.parse_args(argv)
    script = render(args.config, platform=args.platform)
    if args.script:
        with open(args.script, 'w') as f:
            f.write(script)
    else:
        print(script)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
