"""Standard liquid-water observables from one water256 PME trajectory
(examples/bulk_properties.py on the port).

Equilibrates water256 under a Langevin thermostat (298.15 K, 1/ps), then
runs NVE production with a frame every 20 steps (4 fs at 0.2 fs) and
computes, with the port's `analysis`:

  - the O-O radial distribution function (first peak ~0.28 nm),
  - S(q), hydrogen bonds per molecule and the tetrahedral order (every
    4th frame),
  - the molecular-COM mean-squared displacement -> D (Einstein) and the
    Green-Kubo running integral of the COM velocity autocorrelation,
  - the static dielectric constant from total-dipole fluctuations (a dipole
    every 5th frame, each a converged SCF: `analysis.dipole_series`),
  - the VDOS band peaks from the velocity autocorrelation.

The NVE segment is a second Simulation given the first one's state, stepped
20 steps at a time with the health check on, as the script does (each call
seeds the ASPC history from a converged evaluation and ends in another, the
"report edges"); `edge_probe=True` times the same steps as one chunk and
reports the edges' share of the production's wall.

    python -m mbpol_openmm_plugin_tpu_torch.examples.bulk_properties 50000
    python -m mbpol_openmm_plugin_tpu_torch.examples.bulk_properties 200 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from mbpol_openmm_plugin_tpu_torch.examples import _common
from mbpol_openmm_plugin_tpu_torch.utils import cli

T = 298.15
DT = 2e-4                     # ps (0.2 fs, the reference benchmark step)
FRAME_EVERY = 20              # 4 fs frame cadence
DIPOLE_EVERY = 5              # dipole every 5th frame (each costs an SCF)
STRUCTURE_EVERY = 4           # S(q), H-bonds and q_tet on every 4th frame


def production(pot, state, n_frames, frame_every=FRAME_EVERY):
    """(frames, velocities [n_frames, natoms, 3] numpy, the NVE Simulation,
    wall seconds): NVE from `state` in calls of frame_every steps, each
    with the health check."""
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
    sim_nve = Simulation(pot, SimulationConfig(dt=DT, temperature=None))
    sim_nve.state = state
    frames, vels = [], []
    t0 = time.perf_counter()
    for _ in range(n_frames):
        sim_nve.step(frame_every)
        frames.append(cli.to_numpy(sim_nve.state.positions))
        vels.append(cli.to_numpy(sim_nve.state.velocities))
    return np.asarray(frames), np.asarray(vels), sim_nve, time.perf_counter() - t0


def observables(sys_, pot, frames, vels, dt_frame, box, temperature=T,
                structure_every=STRUCTURE_EVERY, dipole_every=DIPOLE_EVERY):
    """Every observable of the script from frames and velocities; the
    Einstein D is None where the MSD is too short for its fit."""
    from mbpol_openmm_plugin_tpu_torch import analysis
    out = {}
    r, g = analysis.radial_distribution(sys_, frames, species='OO')
    k = int(np.argmax(g))
    out.update(rdf_r=r, rdf_g=g, g_oo_peak_nm=float(r[k]), g_oo_peak_height=float(g[k]))
    sub = frames[::structure_every]
    q, s_q = analysis.static_structure_factor(sys_, sub, q_max=40.0)
    j = int(np.argmax(s_q[q > 10.0]))
    out.update(sq_q=q, sq_s=s_q, sq_peak_q=float(q[q > 10.0][j]), sq_peak=float(s_q[q > 10.0][j]))
    hb = analysis.hydrogen_bonds(sys_, sub)
    # each bond is shared by a donor and an acceptor molecule
    out['hbonds_per_molecule'] = float(2.0 * np.mean(hb) / sys_.n_waters)
    out['tetrahedral_order'] = float(np.mean(analysis.tetrahedral_order(sys_, sub)))
    t, msd = analysis.mean_squared_displacement(sys_, frames, dt_frame, species='com')
    out.update(msd_t=t, msd=msd)
    try:
        out['d_einstein_nm2_ps'] = float(analysis.diffusion_coefficient(t, msd))
    except ValueError:
        out['d_einstein_nm2_ps'] = None
    tg, d_run = analysis.diffusion_coefficient_gk(sys_, vels, dt_frame, species='com')
    # plateau read over 1-5 ps (after the COM-VACF decay, before tail noise)
    sel = (tg >= 1.0) & (tg <= 5.0)
    out.update(gk_t=tg, gk_d=d_run, d_gk_plateau_nm2_ps=(float(d_run[sel].mean()) if sel.any()
                                                          else None),
               d_gk_last_nm2_ps=float(d_run[-1]))
    mu = analysis.dipole_series(pot, frames[::dipole_every])
    out.update(dipoles=mu, epsilon=float(analysis.static_dielectric(mu, box, temperature)))
    freq, vdos = analysis.vibrational_density_of_states(sys_, vels, dt_frame)
    peaks = {}
    for lo, hi, name in _common.BANDS:
        m = (freq >= lo) & (freq < hi)
        if m.any() and vdos[m].max() > 0:
            peaks[name] = float(freq[m][int(np.argmax(vdos[m]))])
    out.update(vdos_freq=freq, vdos=vdos, vdos_peaks=peaks,
               nyquist_invcm=0.5 / dt_frame / 0.0299792458)
    return out


def report(obs, n_frames, dt_frame, say=print):
    say(f'{n_frames} frames over {n_frames * dt_frame:.2f} ps')
    say(f'g_OO(r) first peak: r = {obs["g_oo_peak_nm"]:.3f} nm, g = {obs["g_oo_peak_height"]:.2f} '
        f'(MB-pol liquid: ~0.28 nm)')
    say(f'S(q) main peak: q = {obs["sq_peak_q"]:.1f} 1/nm, S = {obs["sq_peak"]:.2f} '
        f'(liquid water: ~20 1/nm (2 A^-1), ~2-3)')
    say(f'H-bonds/molecule = {obs["hbonds_per_molecule"]:.2f} (liquid water: ~3.5)')
    say(f'tetrahedral order <q> = {obs["tetrahedral_order"]:.3f} '
        f'(liquid ~0.6-0.7, ice 1, ideal gas 0)')
    d = obs['d_einstein_nm2_ps']
    if d is None:
        say('MSD too short for a diffusion fit')
    else:
        say(f'D(COM, Einstein) = {d:.3e} nm^2/ps = {d * 1e-2:.3e} cm^2/s '
            f'(expt 2.3e-5 cm^2/s; needs >=100 ps to converge)')
    if obs['d_gk_plateau_nm2_ps'] is not None:
        say(f'D(COM, Green-Kubo) = {obs["d_gk_plateau_nm2_ps"]:.3e} nm^2/ps')
    else:
        say(f'GK running integral at t_max={obs["gk_t"][-1]:.2f} ps: '
            f'{obs["d_gk_last_nm2_ps"]:.3e} nm^2/ps (trajectory too short for a plateau)')
    say(f'epsilon_0 = {obs["epsilon"]:.1f} from {len(obs["dipoles"])} dipole samples '
        f'(expt ~78; <M^2> converges on ns scales - short runs underestimate)')
    for name, f in obs['vdos_peaks'].items():
        say(f'VDOS {name:12s} peak {f:7.0f} cm^-1')
    if obs['nyquist_invcm'] < 4400:
        say(f'(frame cadence Nyquist {obs["nyquist_invcm"]:.0f} cm^-1 - OH stretch needs '
            f'FRAME_EVERY <= 2 at this dt)')


def run(n_steps=2000, device='cuda', seed=11, check_health=False, edge_probe=False, echo=True):
    """The script's pipeline; returns its readings (`observables`, the frame
    count, steps/s and, with edge_probe, the edges' share)."""
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
    say = print if echo else (lambda *a, **k: None)
    n_eq = min(n_steps, 2000)
    sys_, pot, pos, box = _common.water_potential(device)
    sim = Simulation(pot, SimulationConfig(dt=DT, temperature=T, thermostat='langevin',
                                           friction=1.0), seed=seed)
    sim.set_positions(pos)
    sim.set_velocities_to_temperature(T)
    say(f'equilibrating {n_eq} NVT steps, then {n_steps} NVE steps '
        f'(frames every {FRAME_EVERY * DT * 1e3:.1f} fs)')
    t0 = time.perf_counter()
    sim.step(n_eq, check_health=check_health)
    eq_wall = time.perf_counter() - t0
    frames, vels, sim_nve, wall = production(pot, sim.state, max(n_steps // FRAME_EVERY, 2))
    dt_frame = FRAME_EVERY * DT
    t0 = time.perf_counter()
    obs = observables(sys_, pot, frames, vels, dt_frame, box)
    report(obs, len(frames), dt_frame, say)
    n_prod = len(frames) * FRAME_EVERY
    out = dict(obs, n_frames=len(frames), eq_steps_per_second=n_eq / eq_wall,
               production_steps_per_second=n_prod / wall, analysis_s=time.perf_counter() - t0,
               captured=sim_nve.captured)
    if edge_probe:
        rate, share = _common.edge_share(sim_nve, n_prod, wall)
        out.update(one_chunk_steps_per_second=rate, edge_share=share)
        say(f'production {n_prod / wall:.1f} steps/s in calls of {FRAME_EVERY}, '
            f'{rate:.1f} as one chunk: the edges take {out["edge_share"]:.1%} of the wall')
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('n_steps', nargs='?', type=int, default=2000)
    cli.add_device_argument(ap)
    a = ap.parse_args(argv)
    run(a.n_steps, a.device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
