"""Bulk-observable validation against published MB-pol liquid-water values
(the port's counterpart of tools/bulk_validation.py, with its protocol,
bands and output keys).

  1. NPT (Langevin 1/ps + MC barostat every 25 steps, 298.15 K / 1 bar):
     --npt-eq-ps of equilibration, then --npt-ps in segments of 2500 steps;
     the density is the mean over the second half of the segments' volumes.
     Band 0.96-1.06 g/cm^3 (classical MB-pol NPT ~1.007; Reddy et al.,
     J. Chem. Phys. 145, 194504 (2016)).
  2. Production at the NPT mean box: the molecule centroids are scaled onto
     the cube of the mean volume, 1000 steps settle, then --nve-ps with a
     frame every --frame-every steps (NVE, or weak-friction Langevin 0.2/ps
     with --thermostat langevin). g_OO first peak 0.265-0.290 nm, height
     2.4-3.6 (MB-pol ~0.276 nm / ~3.1); D_self(COM, Einstein) 1.0e-5 -
     3.5e-5 cm^2/s (MB-pol classical ~2.2e-5; N = 256 lowers it ~10%).

Prints one JSON line with every observable and the band verdicts; exits 1
if a band fails. The potential is MBPolConfig.for_dynamics() on the card
(float32; each MD step one CUDA graph replay), float64 with --device cpu.

    python -m mbpol_openmm_plugin_tpu_torch.tools.bulk_validation --npt-ps 5 --nve-ps 10
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from mbpol_openmm_plugin_tpu_torch.utils import cli

WATER_MOLAR_G = 18.01528
AMU_G = 1.66053906660e-24
T_K = 298.15
KB = 0.008314462618
NPT_SEGMENT = 2500
SETTLE_STEPS = 1000
BANDS = dict(density=(0.96, 1.06), g_oo_peak_r=(0.265, 0.290), g_oo_peak_h=(2.4, 3.6),
             d_self_cm2_s=(1.0e-5, 3.5e-5))


def density_g_cm3(n_waters, vol_nm3):
    return n_waters * WATER_MOLAR_G * AMU_G / (vol_nm3 * 1e-21)


def npt_density(n_waters, volumes):
    """(mean density, its standard deviation, mean volume) over the second
    half of the NPT segments' volumes."""
    vols = np.asarray(volumes, np.float64)
    half = vols[len(vols) // 2:]
    return (density_g_cm3(n_waters, half.mean()),
            float(np.std(density_g_cm3(n_waters, half))), float(half.mean()))


def centroid_rescale(system, positions, box_edge, length):
    """positions (float64 numpy) with every molecule's mass-weighted centroid
    scaled by length / box_edge about the origin (its atoms moved with it)."""
    scale = float(length) / float(box_edge)
    mol = np.asarray(system.mol_index)
    m = np.asarray(system.masses)
    p = np.asarray(positions, np.float64)
    nmol = mol.max() + 1
    mm = np.zeros(nmol)
    np.add.at(mm, mol, m)
    cen = np.zeros((nmol, 3))
    np.add.at(cen, mol, m[:, None] * p)
    cen /= mm[:, None]
    return p + (cen * (scale - 1.0))[mol]


def band_verdicts(values):
    """{name: inside its band} for the observables of BANDS."""
    return {k: bool(BANDS[k][0] <= values[k] <= BANDS[k][1]) for k in BANDS}


def drift_K_per_ns(e_first, e_last, n_steps, dt_ps):
    """The production's end-to-end total-energy change as K/ns of the 768
    real atoms' 3 N degrees of freedom."""
    return (e_last - e_first) / (0.5 * 3 * 768 * KB) / (n_steps * dt_ps * 1e-3)


def run(npt_ps=50.0, nve_ps=100.0, npt_eq_ps=10.0, dt_fs=0.2, thermostat='nve', aspc_n_corr=2,
        frame_every=100, seed=11, device='cuda', check_health=False, echo=True):
    """The protocol of the module docstring; returns the printed dict (with
    the NVE frames' count, the steps/s of each stage and the capture count
    beside the JAX tool's keys)."""
    from mbpol_openmm_plugin_tpu_torch import analysis
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.system import System, compute_virtual_sites

    dev = cli.device(device)
    dt = dt_fs * 1e-3
    box = [cli.BOX256] * 3
    sys_ = System.waters(256, box=box)
    pot = MBPol(sys_, MBPolConfig.for_dynamics(aspc_n_corr=aspc_n_corr), device=dev)
    pos = compute_virtual_sites(sys_, pot.as_positions(cli.water256_positions()))
    pot.tune_capacities(pos, margin=1.6)

    t0 = time.time()
    # ---- stage 1: NPT ------------------------------------------------------
    npt = Simulation(pot, SimulationConfig(
        dt=dt, temperature=T_K, thermostat='langevin', friction=1.0, barostat_pressure=1.0,
        barostat_interval=25, nlist_rebuild_interval='auto'), seed=seed)
    npt.set_positions(pos)
    npt.set_velocities_to_temperature(T_K)
    n_eq = int(round(npt_eq_ps * 1e3 / dt_fs))
    n_npt = int(round(npt_ps * 1e3 / dt_fs))
    t_npt = time.time()
    npt.step(n_eq, report_interval=min(n_eq, NPT_SEGMENT), check_health=check_health)
    vols = []
    done = 0
    moves = [0, 0]
    while done < n_npt:
        out = npt.step(NPT_SEGMENT, report_interval=NPT_SEGMENT, check_health=check_health)
        moves[0] += out['barostat_attempted']
        moves[1] += out['barostat_accepted']
        b = np.asarray(npt.state.box, np.float64)
        vols.append(float(b[0] * b[1] * b[2]))
        done += NPT_SEGMENT
    npt_rate = (n_eq + done) / (time.time() - t_npt)
    rho, rho_sd, v_mean = npt_density(256, vols)

    # ---- stage 2: production at the NPT mean box -----------------------
    L = float(v_mean ** (1.0 / 3.0))
    st = npt.state
    p = centroid_rescale(sys_, cli.to_numpy(st.positions), float(np.asarray(st.box)[0]), L)
    box2 = [L, L, L]
    sys2 = System.waters(256, box=box2)
    pot2 = MBPol(sys2, MBPolConfig.for_dynamics(aspc_n_corr=aspc_n_corr), device=dev)
    pot2.tune_capacities(pot2.as_positions(p), margin=1.6)
    cfg2 = SimulationConfig(dt=dt, temperature=None, nlist_rebuild_interval='auto')
    if thermostat == 'langevin':
        cfg2 = SimulationConfig(dt=dt, temperature=T_K, thermostat='langevin', friction=0.2,
                                nlist_rebuild_interval='auto')
    prod = Simulation(pot2, cfg2, seed=seed + 1)
    prod.set_positions(p)
    prod.state = dataclasses.replace(prod.state, velocities=pot2.as_positions(
        cli.to_numpy(st.velocities)))
    n_prod = int(round(nve_ps * 1e3 / dt_fs))
    # short settle after the box rescale
    prod.step(SETTLE_STEPS, report_interval=SETTLE_STEPS, check_health=check_health)
    frames = []
    e_first = e_last = None
    done = 0
    t_prod = time.time()
    while done < n_prod:
        mtr = prod.step(frame_every, report_interval=frame_every, check_health=check_health)
        if e_first is None:
            e_first = float(mtr['total_energy'][-1])
        e_last = float(mtr['total_energy'][-1])
        frames.append(cli.to_numpy(prod.state.positions))
        done += frame_every
    prod_rate = done / (time.time() - t_prod)
    frames = np.asarray(frames)
    dt_frame = frame_every * dt

    r, g = analysis.radial_distribution(sys2, frames, species='OO')
    k = int(np.argmax(g))
    g_peak_r, g_peak = float(r[k]), float(g[k])
    t, msd = analysis.mean_squared_displacement(sys2, frames, dt_frame, species='com')
    d_cm2_s = float(analysis.diffusion_coefficient(t, msd)) * 1e-2
    drift = drift_K_per_ns(e_first, e_last, n_prod, dt) if thermostat == 'nve' else None

    vals = dict(density=rho, g_oo_peak_r=g_peak_r, g_oo_peak_h=g_peak, d_self_cm2_s=d_cm2_s)
    ok = band_verdicts(vals)
    out = dict(
        protocol=dict(npt_ps=npt_ps, nve_ps=nve_ps, npt_eq_ps=npt_eq_ps, dt_fs=dt_fs,
                      thermostat=thermostat, n_corr=aspc_n_corr, frames=len(frames), seed=seed,
                      device=str(dev)),
        density_g_cm3=rho, density_sd=rho_sd, npt_segments=len(vols),
        barostat_moves=dict(attempted=moves[0], accepted=moves[1]),
        g_oo_first_peak_nm=g_peak_r, g_oo_first_peak_height=g_peak, d_self_cm2_s=d_cm2_s,
        production_drift_K_per_ns=drift,
        bands={k: list(v) for k, v in BANDS.items()}, band_ok=ok, all_ok=bool(all(ok.values())),
        npt_steps_per_second=npt_rate, production_steps_per_second=prod_rate,
        captures=len(npt.capture_ms) + len(prod.capture_ms),
        minutes=(time.time() - t0) / 60.0)
    if echo:
        print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--npt-ps', type=float, default=50.0)
    ap.add_argument('--nve-ps', type=float, default=100.0)
    ap.add_argument('--npt-eq-ps', type=float, default=10.0)
    ap.add_argument('--dt-fs', type=float, default=0.2)
    ap.add_argument('--thermostat', default='nve', choices=['nve', 'langevin'])
    ap.add_argument('--aspc-n-corr', type=int, default=2)
    ap.add_argument('--frame-every', type=int, default=100)
    ap.add_argument('--seed', type=int, default=11)
    cli.add_device_argument(ap)
    a = ap.parse_args(argv)
    out = run(a.npt_ps, a.nve_ps, a.npt_eq_ps, a.dt_fs, a.thermostat, a.aspc_n_corr,
              a.frame_every, a.seed, a.device)
    return 0 if out['all_ok'] else 1


if __name__ == '__main__':
    sys.exit(main())
