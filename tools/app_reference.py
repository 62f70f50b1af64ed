"""Reference readings of the app-layer phase of chip_smoke.py (24), through
the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tools/app_reference.py [--what fixture app] [--out FILE]

fixture  the water256 fixture (tests/fixtures/water256_integration_test.npz,
         made whole, M sites placed) single point under chip_smoke.py's
         SINGLE_POINT configuration (PME, cutoff 0.9 nm, target_epsilon
         1e-4, nlist_skin 0.02 nm, max_iterations 200): the total and the
         two-body, three-body and electrostatics terms in float32, and in
         float64 at the float32-rounded positions (the same input), kcal/mol.
app      the app-layer bulk single point of examples/example_ini/
         mbpol_bulk_energy.ini: water256_bulk.pdb written from
         tests/fixtures/water256_bulk.npz by the JAX writer into a temporary
         directory, PDBFile, the box set to 1.93996888399961804 nm,
         ForceField(mbpol.xml).createSystem(PME, cutoff 0.9 nm,
         ewaldErrorTolerance 1e-4), app.Simulation, getState: the energy in
         float32 and float64, |dE| (kcal/mol) and max |dF| / max |F| of the
         float64 forces.

Float32 runs with x64 off, float64 inside jax.enable_x64(True). The last
line is a JSON object of the readings.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FIXTURES = os.path.join(REPO, 'tests', 'fixtures')
FIXTURE = os.path.join(FIXTURES, 'water256_integration_test.npz')
BOX = 19.3996888399961804 / 10.0
SINGLE_POINT = dict(nonbonded_method='PME', cutoff=0.9, target_epsilon=1e-4, nlist_skin=0.02,
                    max_iterations=200)
KCAL = 1.0 / 4.184


def fixture(readings):
    import jax
    import jax.numpy as jnp

    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu.system import (System, compute_virtual_sites,
                                                make_molecules_whole)
    with np.load(FIXTURE) as z:
        names, resnames = z['names'], z['resnames']
        pos32 = np.asarray(z['positions'], np.float32).astype(np.float64)
    for name, dtype in (('f32', jnp.float32), ('f64', jnp.float64)):
        with jax.enable_x64(dtype == jnp.float64):
            t0 = time.perf_counter()
            system = System.from_atom_names(names, resnames, box=[BOX] * 3)
            pos = compute_virtual_sites(system, make_molecules_whole(
                system, jnp.asarray(pos32, dtype)))
            e, _, parts, _ = MBPol(system, MBPolConfig(**SINGLE_POINT)).energy_forces(pos)
            row = dict(total=float(e) * KCAL,
                       **{k: float(parts[k]) * KCAL
                          for k in ('two_body', 'three_body', 'electrostatics')})
            print(f'fixture {name}: ' + ', '.join(f'{k} {v:.4f}' for k, v in row.items())
                  + f' kcal/mol ({time.perf_counter() - t0:.1f} s)', flush=True)
            readings[f'fixture_{name}'] = row


def app(readings):
    import jax

    from mbpol_openmm_plugin_tpu import app as A
    from mbpol_openmm_plugin_tpu.app import unit
    from mbpol_openmm_plugin_tpu.app.pdbfile import Atom, Topology, write_pdb_frame

    with np.load(os.path.join(FIXTURES, 'water256_bulk.npz')) as z:
        atoms = [Atom(i, str(n), str(rn), int(ri)) for i, (n, rn, ri) in
                 enumerate(zip(z['names'], z['resnames'], z['resids']))]
        positions = np.array(z['positions'])
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'water256_bulk.pdb')
        with open(path, 'w') as fh:
            write_pdb_frame(fh, Topology(atoms), positions)
        for name in ('f32', 'f64'):
            with jax.enable_x64(name == 'f64'):
                t0 = time.perf_counter()
                pdb = A.PDBFile(path)
                pdb.topology.setUnitCellDimensions((BOX, BOX, BOX) * unit.nanometer)
                ff = A.ForceField(A.mbpol_xml_path())
                system = ff.createSystem(pdb.topology, nonbondedMethod=A.PME,
                                         nonbondedCutoff=0.9 * unit.nanometer,
                                         ewaldErrorTolerance=1e-4)
                sim = A.Simulation(pdb.topology, system,
                                   A.VerletIntegrator(0.5 * unit.femtoseconds))
                sim.context.setPositions(pdb.positions)
                state = sim.context.getState(getEnergy=True, getForces=True)
                e = state.getPotentialEnergy().value_in_unit(unit.kilocalorie_per_mole)
                f = np.asarray(state.getForces().to_internal(), np.float64)
                out[name] = (e, f)
                print(f'app {name}: {e:.4f} kcal/mol ({time.perf_counter() - t0:.1f} s)',
                      flush=True)
    de = abs(out['f32'][0] - out['f64'][0])
    f64 = out['f64'][1]
    df = float(np.max(np.abs(out['f32'][1] - f64)) / np.max(np.abs(f64)))
    print(f'app |dE| {de:.4f} kcal/mol, max |dF| / max |F| {df:.4e}', flush=True)
    readings.update(app_f32_kcal=out['f32'][0], app_f64_kcal=out['f64'][0], app_de_kcal=de,
                    app_df_rel=df)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--what', nargs='+', default=['fixture', 'app'])
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    readings = {}
    if 'fixture' in args.what:
        fixture(readings)
    if 'app' in args.what:
        app(readings)
    line = json.dumps(readings)
    if args.out:
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    print(line)


if __name__ == '__main__':
    main()
