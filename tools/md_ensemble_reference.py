"""Reference reading of the NVT gate of chip_smoke.py (phase 13), through the
JAX package, float32, on the CPU.

    JAX_PLATFORMS=cpu python tools/md_ensemble_reference.py [--seeds 0 1 2] [--out FILE]

Protocol (phase 13's): the water256 integration fixture,
MBPolConfig.for_dynamics(), Simulation with Langevin (BAOAB) at 300 K,
friction 100/ps, 0.2 fs, cm_motion_interval=1, displacement-triggered list
rebuilds; set_velocities_to_temperature(300) from the seed, then 400 steps
in reports of 10 (Simulation.step(400, report_interval=10)). It prints,
per seed, the mean kinetic temperature over the reports of the second half
(steps 210..400; the JAX Simulation reports the temperature at report
boundaries only) and its spread, and ends with a JSON line. About 7 minutes
per seed on four CPU cores.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FIXTURE = os.path.join(REPO, 'tests', 'fixtures', 'water256_integration_test.npz')
BOX = 19.3996888399961804 / 10.0
STEPS = 400
REPORT = 10
TEMPERATURE = 300.0
FRICTION = 100.0      # 1/ps
DT = 0.0002           # ps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seeds', type=int, nargs='+', default=[0, 1, 2])
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from mbpol_openmm_plugin_tpu.md.simulation import Simulation, SimulationConfig
    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu.system import (System, compute_virtual_sites,
                                                make_molecules_whole)

    with np.load(FIXTURE) as z:
        system = System.from_atom_names(z['names'], z['resnames'], box=[BOX] * 3)
        pos = jnp.asarray(np.array(z['positions']), jnp.float32)
    pos = compute_virtual_sites(system, make_molecules_whole(system, pos))
    pot = MBPol(system, MBPolConfig.for_dynamics())
    cfg = SimulationConfig(dt=DT, temperature=TEMPERATURE, thermostat='langevin',
                           friction=FRICTION, cm_motion_interval=1,
                           nlist_rebuild_interval='auto')
    runs = []
    t0 = time.perf_counter()
    for seed in args.seeds:
        sim = Simulation(pot, cfg, seed=seed)
        sim.set_positions(pos)
        sim.set_velocities_to_temperature(TEMPERATURE)
        out = sim.step(STEPS, report_interval=REPORT)
        t = np.asarray(out['temperature'], np.float64)
        half = t[np.asarray(out['step']) > STEPS // 2]
        row = dict(seed=seed, mean_temperature_second_half=float(half.mean()),
                   std_temperature_second_half=float(half.std()), n_reports=int(len(half)),
                   final_temperature=float(t[-1]))
        runs.append(row)
        print(f'seed {seed}: mean T over steps {STEPS // 2 + REPORT}..{STEPS} '
              f'{row["mean_temperature_second_half"]:.3f} K '
              f'(std {row["std_temperature_second_half"]:.3f}, {len(half)} reports), T_end {row["final_temperature"]:.3f} K '
              f'({time.perf_counter() - t0:.0f} s)', flush=True)
    result = dict(platform='cpu', dtype='float32', jax=jax.__version__, temperature=TEMPERATURE,
                  friction=FRICTION, steps=STEPS, report_interval=REPORT, runs=runs,
                  mean_over_seeds=float(np.mean([r['mean_temperature_second_half']
                                                 for r in runs])))
    line = json.dumps(result)
    if args.out:
        with open(args.out, 'w') as fh:
            fh.write(line + '\n')
    print(line)


if __name__ == '__main__':
    main()
