"""r-RESPA NVE drift per variant (the port's counterpart of
tools/respa_drift.py, with its arms, defaults and JSON keys).

water256 under MBPolConfig.for_dynamics(scf_method, target_epsilon,
scf_eps_floor, aspc_n_corr) after tune_capacities(margin=1.4), velocity
Verlet r-RESPA with the one-body term on the inner rung and, with
--mid > 1, a middle rung (the polarization on it, or with --polar-rung
inner beside the one-body term); outer step 0.2 fs x inner x mid,
displacement-triggered lists. Maxwell-Boltzmann velocities at 300 K,
--therm outer steps, then --steps outer steps read every --seg; the drift
is the linear fit of the total energy over the segment ends, in K/ns
(Delta E / ((3 N / 2) k_B), N = 768 real atoms).

  --scf keep|auto       'keep' runs the potential's own SCF (converged
                        loop) on its rung; 'auto' derives ASPC
  --scf-method ...      base potential SCF (sor|diis|aspc) for 'keep'
  --epsilon/--eps-floor convergence target for the 'keep' arms
  --n-corr              ASPC corrector depth (with --scf auto)
  --mid/--inner         the RESPA ladder

The port runs r-RESPA eagerly (md/simulation.Simulation).

    python -m mbpol_openmm_plugin_tpu_torch.tools.respa_drift --steps 8333 --mid 3
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from mbpol_openmm_plugin_tpu_torch.utils import cli

KB = 0.008314462618
NDOF = 3 * 768


def drift_fit(ts, es):
    """(slope kJ/mol/ps of the linear fit of es over ts, the drift in K/ns)."""
    slope = float(np.polyfit(np.asarray(ts), np.asarray(es), 1)[0])
    return slope, slope * 1e3 / (0.5 * NDOF * KB)


def run(steps=8333, therm=1000, mid=3, inner=2, scf='auto', scf_method='sor', epsilon=1e-3,
        eps_floor=None, n_corr=1, seg=500, polar_rung='mid', device='cuda', check_health=False,
        echo=True):
    """One arm; returns the printed dict (and the energy series)."""
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.system import System, compute_virtual_sites

    dev = cli.device(device)
    box = [cli.BOX256] * 3
    sys_ = System.waters(256, box=box)
    pot = MBPol(sys_, MBPolConfig.for_dynamics(scf_method=scf_method, target_epsilon=epsilon,
                                               scf_eps_floor=eps_floor, aspc_n_corr=n_corr),
                device=dev)
    pos = compute_virtual_sites(sys_, pot.as_positions(cli.water256_positions()))
    pot.tune_capacities(pos, margin=1.4)
    dt_outer = 0.2e-3 * inner * mid
    sim = Simulation(pot, SimulationConfig(
        dt=dt_outer, temperature=None, scf=scf, respa_inner=inner, respa_mid=mid,
        respa_polarization_rung=polar_rung, nlist_rebuild_interval='auto'), seed=0)
    sim.set_positions(pos)
    sim.set_velocities_to_temperature(300.0)
    sim.step(therm, report_interval=therm, check_health=check_health)

    ts, es = [], []
    t0 = time.time()
    done = 0
    while done < steps:
        m = sim.step(seg, report_interval=seg, check_health=check_health)
        done += seg
        ts.append(done * dt_outer)
        es.append(float(np.asarray(m['total_energy'])[-1]))
    elapsed = time.time() - t0
    ts, es = np.asarray(ts), np.asarray(es)
    _, k_per_ns = drift_fit(ts, es)
    out = dict(variant=dict(mid=mid, inner=inner, scf=scf, scf_method=scf_method,
                            epsilon=epsilon, eps_floor=eps_floor, n_corr=n_corr,
                            polar_rung=polar_rung, outer_steps=steps, device=str(dev)),
               window_ps=float(ts[-1] - ts[0]),
               outer_steps_per_second=steps / elapsed,
               ns_per_day=steps / elapsed * dt_outer * 1e-3 * 86400.0,
               drift_K_per_ns=k_per_ns, endpoint_drift_kJmol=float(es[-1] - es[0]),
               nan=bool(np.isnan(es).any()))
    if echo:
        print(json.dumps(out), flush=True)
    return dict(out, series=es)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--steps', type=int, default=8333)   # outer steps
    ap.add_argument('--therm', type=int, default=1000)
    ap.add_argument('--mid', type=int, default=3)
    ap.add_argument('--inner', type=int, default=2)
    ap.add_argument('--scf', default='auto', choices=['auto', 'keep'])
    ap.add_argument('--scf-method', default='sor')
    ap.add_argument('--epsilon', type=float, default=1e-3)
    ap.add_argument('--eps-floor', type=float, default=None)
    ap.add_argument('--n-corr', type=int, default=1)
    ap.add_argument('--seg', type=int, default=500)
    ap.add_argument('--polar-rung', default='mid', choices=['mid', 'inner'])
    cli.add_device_argument(ap)
    a = ap.parse_args(argv)
    run(a.steps, a.therm, a.mid, a.inner, a.scf, a.scf_method, a.epsilon, a.eps_floor,
        a.n_corr, a.seg, a.polar_rung, a.device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
