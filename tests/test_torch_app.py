"""The port's app layer (mbpol_openmm_plugin_tpu_torch.app) on the CPU in
float64 (platform='CPU'): every case of tests/test_app.py with the
reference goldens, the same cases against the JAX app (energy and forces
within 1e-8 relative), the XML variants, HMR and isotope masses equal to
the JAX ones, the reporters, 10 NVE steps from the same velocities
against the JAX app (positions within 1e-9 nm), the PDB writer's bytes
against the JAX writer's, the NetCDF round trip, and the card as the
default platform.
"""
import os
import re

import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu import app as japp
from mbpol_openmm_plugin_tpu.app import pdbfile as jpdbfile
from mbpol_openmm_plugin_tpu_torch import app
from mbpol_openmm_plugin_tpu_torch.app import pdbfile
from mbpol_openmm_plugin_tpu_torch.app import unit
from test_torch_step_capture import guard  # noqa: F401  (the host-read guard fixture)

torch.set_num_threads(1)

CPU = app.Platform.getPlatformByName('CPU')
REL = 1e-8
NAMES = ('water2', 'water3', 'water14', 'water_and_ion', 'water50')


def _write(mod, name, path, box=None, model_index=None):
    d = fixtures.load(name)
    atoms = [mod.Atom(i, str(n), str(rn), int(ri)) for i, (n, rn, ri) in
             enumerate(zip(d['names'], d['resnames'], d['resids']))]
    with open(path, 'w') as fh:
        mod.write_pdb_frame(fh, mod.Topology(atoms, box=box), d['positions'], model_index)


@pytest.fixture(scope='module')
def pdb_dir(tmp_path_factory):
    """PDB files of the fixtures written by the port's writer."""
    tmp = tmp_path_factory.mktemp('pdb')
    paths = {}
    for name in NAMES:
        paths[name] = str(tmp / f'{name}.pdb')
        _write(pdbfile, name, paths[name])
    return paths


def _simulation(mod, pdb_path, remove=(), nonbondedMethod='CutoffNonPeriodic', cutoff=1.0,
                box=None, **kw):
    """tests/test_app.py's set-up through app module `mod` (the port's on the
    CPU, or the JAX one)."""
    pdb = mod.PDBFile(pdb_path)
    if box is not None:
        pdb.topology.setUnitCellDimensions(box)
    ff = mod.ForceField(mod.mbpol_xml_path())
    system = ff.createSystem(pdb.topology, nonbondedMethod=nonbondedMethod,
                             nonbondedCutoff=cutoff * mod.unit.nanometer)
    for i in remove:
        system.removeForce(i)
    integrator = mod.VerletIntegrator(0.02 * mod.unit.femtoseconds)
    sim = mod.Simulation(pdb.topology, system, integrator, **kw)
    sim.context.setPositions(pdb.positions)
    sim.context.computeVirtualSites()
    return sim


def _energy_forces(mod, sim):
    state = sim.context.getState(getEnergy=True, getForces=True)
    return (state.getPotentialEnergy().value_in_unit(mod.unit.kilocalorie_per_mole),
            np.asarray(state.getForces().to_internal()))


# test_app.py's cases: (fixture, set-up, golden kcal/mol, tolerance)
GOLDEN_CASES = {
    # force order: elec, one, two, three, CMMotionRemover, CustomDispersion
    'force_isolation_two_body': ('water2', dict(remove=[0, 0, 1, 1, 1]), 6.14207815, 0.01),
    'force_isolation_dispersion': ('water3', dict(remove=[0, 0, 0, 0, 0]), -6.84471477, 0.01),
    'water14_total_pme': ('water14', dict(nonbondedMethod='PME', cutoff=0.9,
                                          box=[1.8, 1.8, 1.8]), -60.0, 1.0),
    'water3_total_cluster_app': ('water3', dict(cutoff=0.9), -8.78893485, 0.1),
}


@pytest.mark.parametrize('case', sorted(GOLDEN_CASES))
def test_golden_and_jax_app(case, pdb_dir):
    name, setup, golden, tol = GOLDEN_CASES[case]
    e, f = _energy_forces(app, _simulation(app, pdb_dir[name], platform=CPU, **setup))
    assert abs(e - golden) < tol, e
    e_ref, f_ref = _energy_forces(japp, _simulation(japp, pdb_dir[name], **setup))
    assert abs(e - e_ref) <= REL * abs(e_ref), (e, e_ref)
    np.testing.assert_allclose(f, f_ref, rtol=0, atol=REL * np.max(np.abs(f_ref)))


def test_pdb_writer_bytes_equal_jax(tmp_path):
    """The port's writer and the JAX one give the same bytes: plain, with a
    box record, and as a MODEL frame; the reader round-trips them."""
    for name in NAMES:
        for kw in ({}, dict(box=[1.8, 1.9, 2.0]), dict(box=[1.8] * 3, model_index=1)):
            ours, ref = tmp_path / 'ours.pdb', tmp_path / 'ref.pdb'
            _write(pdbfile, name, ours, **kw)
            _write(jpdbfile, name, ref, **kw)
            assert ours.read_bytes() == ref.read_bytes(), (name, kw)
    pdb = app.PDBFile(str(ours))
    ref = fixtures.load(NAMES[-1])
    np.testing.assert_allclose(pdb.positions.to_internal(), ref['positions'], atol=1e-4)
    np.testing.assert_allclose(pdb.topology.getUnitCellDimensions(), [1.8] * 3)


def test_xml_files_and_variants(pdb_dir, tmp_path):
    """The shipped variants (no dispersion, no redistribution; dispersion
    only with its golden), an edited mbpol.xml, the old per-Residue thole
    dialect, and the refusals: CutoffPeriodic electrostatics, ions under
    the full force field."""
    d = os.path.dirname(app.mbpol_xml_path())
    assert d == os.path.dirname(os.path.abspath(app.__file__))
    pdb = app.PDBFile(pdb_dir['water3'])

    base = re.sub(r'<Script>.*?</Script>', '', open(app.mbpol_xml_path()).read(), flags=re.S)
    base = base.replace('</MBPolElectrostaticsForce>',
                        '    <setIncludeChargeRedistribution chargeRedistribution="False"/>\n'
                        '    </MBPolElectrostaticsForce>')
    (tmp_path / 'variant.xml').write_text(base)
    for path in (str(tmp_path / 'variant.xml'),
                 os.path.join(d, 'mbpol_no_custom_dispersion_no_charge_redistribution.xml')):
        ff = app.ForceField(path)
        assert ff.has_electrostatics and ff.has_one_body
        assert not ff.has_dispersion and not ff.include_charge_redistribution
        system = ff.createSystem(pdb.topology, nonbondedMethod=app.CutoffNonPeriodic,
                                 nonbondedCutoff=0.9 * unit.nanometer)
        assert system.getNumForces() == 5
        sim = app.Simulation(pdb.topology, system,
                             app.VerletIntegrator(0.02 * unit.femtoseconds), platform=CPU)
        sim.context.setPositions(pdb.positions)
        e = sim.context.getState(getEnergy=True).getPotentialEnergy()
        assert np.isfinite(e.value_in_unit(unit.kilocalorie_per_mole))
        assert not sim.potential.config.include_charge_redistribution

    ff = app.ForceField(os.path.join(d, 'customdispersion.xml'))
    assert ff.has_dispersion and not ff.has_electrostatics
    system = ff.createSystem(pdb.topology, nonbondedMethod=app.CutoffNonPeriodic,
                             nonbondedCutoff=1.0 * unit.nanometer)
    sim = app.Simulation(pdb.topology, system, app.VerletIntegrator(0.02 * unit.femtoseconds),
                         platform='CPU')
    sim.context.setPositions(pdb.positions)
    e = sim.context.getState(getEnergy=True).getPotentialEnergy()
    assert abs(e.value_in_unit(unit.kilocalorie_per_mole) - (-6.84471477)) < 0.01

    xml = """<ForceField>
    <MBPolElectrostaticsForce>
        <Residue name="HOH" class1="O" class2="H" class3="H" thole-charge-charge="0.4" thole-charge-dipole="0.4" thole-dipole-dipole-intermolecules="0.055" thole-dipole-dipole-OH="0.626" thole-dipole-dipole-HH="0.055"/>
        <setIncludeChargeRedistribution chargeRedistribution="False"/>
    </MBPolElectrostaticsForce>
</ForceField>"""
    (tmp_path / 'old.xml').write_text(xml)
    ff = app.ForceField(str(tmp_path / 'old.xml'))
    np.testing.assert_allclose(ff.thole, [0.4, 0.4, 0.055, 0.626, 0.055])
    assert not ff.include_charge_redistribution

    ff = app.ForceField(app.mbpol_xml_path())
    periodic = app.PDBFile(pdb_dir['water3'])
    periodic.topology.setUnitCellDimensions([1.9, 1.9, 1.9])
    with pytest.raises(ValueError, match='CutoffPeriodic'):
        ff.createSystem(periodic.topology, nonbondedMethod=app.CutoffPeriodic,
                        nonbondedCutoff=0.9 * unit.nanometer)
    ion = app.PDBFile(pdb_dir['water_and_ion'])
    with pytest.raises(ValueError, match='ion'):
        ff.createSystem(ion.topology)
    # water + Cl- under the dispersion-only force field evaluates
    system = app.ForceField(os.path.join(d, 'customdispersion.xml')).createSystem(ion.topology)
    sim = app.Simulation(ion.topology, system, app.VerletIntegrator(0.02 * unit.femtoseconds),
                         platform=CPU)
    sim.context.setPositions(ion.positions)
    assert np.isfinite(sim.context.getState(getEnergy=True).getPotentialEnergy()
                       .value_in_unit(unit.kilocalorie_per_mole))


def test_hmr_and_isotope_masses_equal_jax(pdb_dir):
    """createSystem(hydrogenMass=...) and (isotope=...) give the JAX masses
    exactly, and refuse what JAX refuses."""
    for name in ('water3', 'water14'):
        ours = app.ForceField(app.mbpol_xml_path())
        ref = japp.ForceField(japp.mbpol_xml_path())
        top, jtop = app.PDBFile(pdb_dir[name]).topology, japp.PDBFile(pdb_dir[name]).topology
        for kw, jkw in ((dict(hydrogenMass=3.024 * unit.amu),
                         dict(hydrogenMass=3.024 * japp.unit.amu)),
                        (dict(isotope='D2O'), dict(isotope='D2O')),
                        (dict(isotope='HDO'), dict(isotope='HDO')), ({}, {})):
            m = np.asarray(ours.createSystem(top, **kw).system.masses)
            np.testing.assert_array_equal(m, np.asarray(ref.createSystem(jtop, **jkw)
                                                        .system.masses))
        with pytest.raises(ValueError):
            ours.createSystem(top, hydrogenMass=30.0 * unit.amu)
        with pytest.raises(ValueError):
            ours.createSystem(top, isotope='T2O')
        with pytest.raises(ValueError):
            ours.createSystem(top, isotope='D2O', hydrogenMass=2.0 * unit.amu)


def test_md_with_reporters(pdb_dir, tmp_path):
    """test_app.py's reporters, the pressure column of a PME box, and the
    report grid after an off-grid equilibration (the steps JAX reports)."""
    sim = _simulation(app, pdb_dir['water3'], cutoff=0.9, platform=CPU)
    log, traj = str(tmp_path / 'run.log'), str(tmp_path / 'traj.pdb')
    sim.reporters.append(app.StateDataReporter(log, 5, step=True, potentialEnergy=True,
                                               kineticEnergy=True, temperature=True,
                                               volume=True, density=True, speed=True,
                                               totalSteps=10))
    sim.reporters.append(app.PDBReporter(traj, 5))
    sim.context.setVelocitiesToTemperature(100 * unit.kelvin)
    sim.step(10)
    lines = open(log).readlines()
    assert len(lines) == 3 and lines[0].startswith('#"Step"')
    assert [int(line.split(',')[0]) for line in lines[1:]] == [5, 10]
    assert all(np.isfinite(float(v)) for v in lines[2].split(',')[1:4])
    assert open(traj).read().count('MODEL') == 2

    # off-grid equilibration: reporters still fire at absolute steps 2k
    sim = _simulation(app, pdb_dir['water3'], cutoff=0.9, platform=CPU)
    sim.context.setVelocitiesToTemperature(100 * unit.kelvin)
    sim.step(1)
    log2, nc_path = str(tmp_path / 'run2.log'), str(tmp_path / 'run.nc')
    sim.reporters.append(app.StateDataReporter(log2, 2, step=True, potentialEnergy=True))
    sim.reporters.append(app.NetCDFReporter(nc_path, 2, crds=True, vels=True))
    sim.step(9)
    steps = [int(line.split(',')[0]) for line in open(log2).readlines()[1:]]
    assert steps == [2, 4, 6, 8, 10], steps
    from scipy.io import netcdf_file
    nc = netcdf_file(nc_path, mmap=False)
    assert nc.variables['coordinates'].shape[0] == 5
    assert nc.variables['velocities'].shape[0] == 5
    nc.close()

    sim = _simulation(app, pdb_dir['water3'], nonbondedMethod='PME', cutoff=0.8,
                      box=(1.8, 1.8, 1.8), platform=CPU)
    sim.context.setVelocitiesToTemperature(300 * unit.kelvin)
    log3 = str(tmp_path / 'p.log')
    sim.reporters.append(app.StateDataReporter(log3, 2, step=True, pressure=True))
    sim.step(4)
    lines = open(log3).readlines()
    assert 'Pressure (bar)' in lines[0]
    p = [float(line.split(',')[1]) for line in lines[1:]]
    assert len(p) == 2 and all(np.isfinite(p)), p


def test_netcdf_round_trip(pdb_dir, tmp_path):
    """The NetCDF reporter's frames read back with AMBER conventions and the
    State's values in AMBER units (float32), periodic and cluster."""
    from scipy.io import netcdf_file
    for periodic in (False, True):
        kw = (dict(nonbondedMethod='PME', cutoff=0.8, box=(1.8, 1.8, 1.8)) if periodic
              else dict(cutoff=0.9))
        sim = _simulation(app, pdb_dir['water3'], platform=CPU, **kw)
        sim.context.setVelocitiesToTemperature(200 * unit.kelvin)
        path = str(tmp_path / f'rt{periodic}.nc')
        rep = app.NetCDFReporter(path, 1, crds=True, vels=True, frcs=True)
        frames = []
        for _ in range(2):
            sim.step(1)
            state = sim.context.getState(getPositions=True, getVelocities=True, getForces=True)
            rep.report(sim, state)
            frames.append(state)
        rep.close()
        nc = netcdf_file(path, 'r', mmap=False)
        assert nc.Conventions == b'AMBER' and nc.ConventionVersion == b'1.0'
        assert set(nc.variables) >= {'time', 'coordinates', 'velocities', 'forces'}
        assert ('cell_lengths' in nc.variables) == periodic
        for i, state in enumerate(frames):
            np.testing.assert_array_equal(
                nc.variables['coordinates'][i],
                (state.getPositions().to_internal() * 10.0).astype(np.float32))
            np.testing.assert_array_equal(
                nc.variables['velocities'][i],
                (state.getVelocities().to_internal() * 10.0).astype(np.float32))
            np.testing.assert_array_equal(
                nc.variables['forces'][i],
                (state.getForces().to_internal() / 4.184 / 10.0).astype(np.float32))
        np.testing.assert_allclose(nc.variables['time'][:], [0.00002, 0.00004], rtol=1e-6)
        if periodic:
            np.testing.assert_allclose(nc.variables['cell_lengths'][:], 18.0)
        nc.close()


def test_nve_steps_match_jax_app(pdb_dir):
    """10 NVE steps of water3 (cluster, CM motion removed every step, the
    SOR potential's trajectory under ASPC) from the same setVelocities
    array: positions within 1e-9 nm, velocities and energy close, of the
    JAX app's."""
    v = np.random.default_rng(5).normal(0.0, 0.5, size=(12, 3))
    v[3::4] = 0.0
    out = []
    for mod, kw in ((app, dict(platform=CPU)), (japp, {})):
        sim = _simulation(mod, pdb_dir['water3'], cutoff=0.9, **kw)
        sim.context.setVelocities(mod.unit.Quantity(v, mod.unit.nanometer_per_picosecond))
        sim.step(10)
        st = sim.context.getState(getPositions=True, getVelocities=True, getEnergy=True)
        out.append((np.asarray(st.getPositions().to_internal()),
                    np.asarray(st.getVelocities().to_internal()),
                    st.getPotentialEnergy().value_in_unit(mod.unit.kilojoule_per_mole)))
        assert int(sim._core.state.step) == 10
    (p, vel, e), (p_ref, vel_ref, e_ref) = out
    assert np.max(np.abs(p - p[0])) > 0 and np.max(np.abs(p - fixtures.load('water3')[
        'positions'])) > 1e-4
    np.testing.assert_allclose(p, p_ref, rtol=0, atol=1e-9)
    np.testing.assert_allclose(vel, vel_ref, rtol=0, atol=1e-6)
    assert abs(e - e_ref) <= 1e-6


def test_platform_default_is_the_card(pdb_dir):
    """Simulation(...) without a platform runs on the card; without one it
    raises (nothing falls back). 'CPU' runs in float64; other names raise."""
    if torch.cuda.is_available():
        sim = _simulation(app, pdb_dir['water3'], cutoff=0.9)
        assert sim.potential.device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            _simulation(app, pdb_dir['water3'], cutoff=0.9)
        with pytest.raises(RuntimeError, match='no CUDA device'):
            _simulation(app, pdb_dir['water3'], cutoff=0.9,
                        platform=app.Platform.getPlatformByName('CUDA'))
    sim = _simulation(app, pdb_dir['water3'], cutoff=0.9, platform='CPU')
    assert sim.potential.device.type == 'cpu' and sim.potential.dtype == torch.float64
    assert CPU.getName() == 'CPU'
    with pytest.raises(ValueError, match='unknown platform'):
        app.Platform.getPlatformByName('OpenCL')
    with pytest.raises(TypeError):
        _simulation(app, pdb_dir['water3'], cutoff=0.9, platform=3)


def test_app_md_step_reads_nothing_on_the_host(pdb_dir, guard):  # noqa: F811
    """The app layer's potential is the default MBPolConfig (SOR, no skin:
    the lists are built inside every evaluation), its trajectory ASPC
    (scf='auto'), with Andersen collisions and CM removal every step: the
    step body the card captures reads nothing on the host and copies
    nothing to the device after its first call (test_torch_step_capture.py's
    guard), at water50 in a 1.8 nm PME box, where the lists are on."""
    pdb = app.PDBFile(pdb_dir['water50'])
    pdb.topology.setUnitCellDimensions((1.8, 1.8, 1.8) * unit.nanometer)
    system = app.ForceField(app.mbpol_xml_path()).createSystem(
        pdb.topology, nonbondedMethod=app.PME, nonbondedCutoff=0.85 * unit.nanometer)
    system.addForce(app.AndersenThermostat(300 * unit.kelvin, 1000.0 / unit.picoseconds))
    sim = app.Simulation(pdb.topology, system, app.VerletIntegrator(0.2 * unit.femtoseconds),
                         platform=CPU)
    assert sim.potential.use_neighbor_lists and sim.potential.config.nlist_skin == 0.0
    assert sim._core.potential.config.scf_method == 'aspc'
    sim.context.setPositions(pdb.positions)
    sim.context.setVelocitiesToTemperature(300 * unit.kelvin)
    sim.step(3)
    assert len(guard) == 3
    assert np.isfinite(sim.context.getState(getEnergy=True).getPotentialEnergy()
                       .value_in_unit(unit.kilojoule_per_mole))
