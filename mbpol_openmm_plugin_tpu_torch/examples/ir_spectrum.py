"""Classical IR spectrum of a water cluster from the total-dipole series
(examples/ir_spectrum.py on the port).

A Langevin start from rest (300 K, 5/ps, 200 steps) and an NVE trajectory of the
water14 cluster at 0.2 fs, a frame every 2 steps; the total system dipole
(fixed charges + converged induced dipoles, `analysis.dipole_series`) of
every frame, and the dominant bands of the classical IR lineshape
(`analysis.infrared_spectrum`). Liquid-water bands to look for: libration
<1000 cm^-1, HOH bend ~1650 cm^-1, OH stretch ~3400-3700 cm^-1.

The NVE segment is a second Simulation over the same potential given the
first one's state, stepped 2 steps at a time with the health check on, as
the script does: each call seeds the ASPC history from a converged
evaluation and ends in another (the health check), the "report edges".
`edge_probe=True` runs the same number of NVE steps again as one chunk
without the check and reports the share of the production's wall that the
edges take.

    python -m mbpol_openmm_plugin_tpu_torch.examples.ir_spectrum 40000
    python -m mbpol_openmm_plugin_tpu_torch.examples.ir_spectrum 200 --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from mbpol_openmm_plugin_tpu_torch.examples import _common
from mbpol_openmm_plugin_tpu_torch.utils import cli

DT = 2e-4                    # ps (0.2 fs - resolves the OH stretch)
FRAME_EVERY = 2              # record the dipole every 2 steps (0.4 fs)
N_EQ = 200


def potential(device='cuda', pdb_dir=None):
    """(MBPol of the water14 cluster, NoCutoff, eps 1e-5; its positions
    from the example PDB with the M sites placed)."""
    from mbpol_openmm_plugin_tpu_torch import app
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.system import System, compute_virtual_sites
    dev = cli.device(device)
    pdb = app.PDBFile(_common.pdb_path('water14_cluster', pdb_dir))
    sys_ = System.waters(14)
    pot = MBPol(sys_, MBPolConfig(nonbonded_method='NoCutoff', target_epsilon=1e-5), device=dev)
    return pot, compute_virtual_sites(sys_, pot.as_positions(pdb.positions.to_internal()))


def production(pot, state, n_steps, frame_every=FRAME_EVERY):
    """(frames [n_steps // frame_every, natoms, 3] numpy, the NVE
    Simulation, the production's wall seconds): NVE from `state` in calls of
    frame_every steps, each with the health check."""
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
    sim_nve = Simulation(pot, SimulationConfig(dt=DT, temperature=None))
    sim_nve.state = state
    frames = []
    t0 = time.perf_counter()
    for _ in range(n_steps // frame_every):
        sim_nve.step(frame_every)
        frames.append(cli.to_numpy(sim_nve.state.positions))
    return np.asarray(frames), sim_nve, time.perf_counter() - t0


def bands(freq, inten):
    """{band: (peak cm^-1, relative intensity)} of the normalized lineshape."""
    out = {}
    for lo, hi, name in _common.BANDS:
        m = (freq >= lo) & (freq < hi)
        if m.any():
            k = np.argmax(inten[m])
            out[name] = (float(freq[m][k]), float(inten[m][k]))
    return out


def run(n_steps=2000, device='cuda', n_eq=N_EQ, seed=1, check_health=False, edge_probe=False,
        pdb_dir=None, echo=True):
    """The script's pipeline; returns its readings (the frames, the dipole
    series, the spectrum's bands and resolution, steps/s)."""
    from mbpol_openmm_plugin_tpu_torch import analysis
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
    say = print if echo else (lambda *a, **k: None)
    pot, pos = potential(device, pdb_dir)
    sim = Simulation(pot, SimulationConfig(dt=DT, temperature=300.0, thermostat='langevin',
                                           friction=5.0), seed=seed)
    sim.set_positions(pos)
    say(f'equilibrating {n_eq} steps, then {n_steps} NVE steps at dt={DT * 1e3} fs')
    t0 = time.perf_counter()
    sim.step(n_eq, check_health=check_health)
    eq_wall = time.perf_counter() - t0

    # NVE for the production segment (thermostat noise broadens the
    # lineshape), positions every FRAME_EVERY steps
    frames, sim_nve, wall = production(pot, sim.state, n_steps)
    mu = analysis.dipole_series(pot, frames)
    freq, inten = analysis.infrared_spectrum(mu, dt=DT * FRAME_EVERY)
    inten = inten / inten.max()
    peaks = bands(freq, inten)
    say(f'{len(frames)} frames, resolution {freq[1]:.0f} cm^-1')
    for name, (f, i) in peaks.items():
        say(f'{name:12s} peak {f:7.0f} cm^-1  (relative intensity {i:.3f})')
    out = dict(frames=frames, dipoles=mu, n_frames=len(frames), resolution_invcm=float(freq[1]),
               bands=peaks, eq_steps_per_second=n_eq / eq_wall,
               production_steps_per_second=len(frames) * FRAME_EVERY / wall,
               captured=sim_nve.captured)
    if edge_probe:
        rate, share = _common.edge_share(sim_nve, len(frames) * FRAME_EVERY, wall)
        out.update(one_chunk_steps_per_second=rate, edge_share=share)
        say(f'production {out["production_steps_per_second"]:.1f} steps/s in calls of '
            f'{FRAME_EVERY}, {rate:.1f} as one chunk: the edges take {share:.1%} of the wall')
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
