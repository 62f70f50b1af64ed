"""H2O vs D2O liquid densities from NPT path-integral MD
(examples/isotope_density.py on the port).

The MB-pol surface is mass-independent, so in classical NPT the H2O and D2O
molar volumes are the same and the densities differ by the molar-mass ratio
(20.03 / 18.02 = 1.112). Ring-polymer NPT (PIMDSimulation with the
barostat: centroid-scaling volume moves on the ring polymer) puts the
nuclear zero-point motion back, which shifts the molar volume between the
isotopologues: experiment rho(D2O)/rho(H2O) = 1.1077 at 25 C.

Protocol: water256 PME box, 1 atm, 298.15 K, dt 0.2 fs, n_beads contracted
to the centroid (RPC n -> 1), an MC volume move every --interval steps with
adaptive move sizes; the density is the mean over the second half of the
report rows. The defaults show the machinery, not converged averages (the
volume autocorrelation time of water is ~10 ps). Each ring-polymer step is
one CUDA graph replay on the card (the ASPC closure); the graph is captured
anew after an accepted move.

    python -m mbpol_openmm_plugin_tpu_torch.examples.isotope_density 20000 --beads 32
    python -m mbpol_openmm_plugin_tpu_torch.examples.isotope_density 4 --beads 2 \\
        --interval 2 --classical --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from mbpol_openmm_plugin_tpu_torch.examples import _common
from mbpol_openmm_plugin_tpu_torch.utils import cli

T = 298.15                     # K
P_BAR = 1.01325                # 1 atm
DT = 2e-4                      # ps (0.2 fs; OH stretches need a small step)
AMU_PER_NM3_TO_G_CM3 = 1.66053906892e-3   # 1 amu/nm^3 in g/cm^3
SEEDS = {'H2O': 7, 'D2O': 13}


def report_interval(n_steps, interval):
    """The script's report cadence: ~20 rows, a multiple of the barostat
    interval."""
    return max(interval, (n_steps // 20) // interval * interval or interval)


def simulation(isotope, n_beads, interval, device='cuda', positions=None, box=None,
               config=None):
    """The PIMDSimulation of one isotopologue at its start (every bead at
    the positions, spread 0.002 nm on the real atoms when n_beads > 1);
    positions, box and the MBPolConfig default to the water256 fixture's."""
    from mbpol_openmm_plugin_tpu_torch.md.rpmd import PIMDSimulation
    _, pot, pos, box = _common.water_potential(device, isotope, positions, box, config)
    sim = PIMDSimulation(pot, n_beads, dt=DT, temperature=T, tau0=0.1,
                         contraction=1 if n_beads > 1 else None, barostat_pressure=P_BAR,
                         barostat_interval=interval, seed=SEEDS[isotope])
    return sim, pos, box


def density(sim, rows):
    """(density per report row in g/cm^3, the box's total mass in amu)."""
    total_mass = float(np.sum(sim.system.masses))
    return total_mass * AMU_PER_NM3_TO_G_CM3 / np.asarray(rows['volume']), total_mass


def run_one(isotope, n_beads, n_steps, interval, device='cuda', check_health=True, echo=True,
            sim=None):
    """One isotopologue: (tail mean density, total mass, the readings)."""
    if sim is None:
        sim, pos, box = simulation(isotope, n_beads, interval, device)
        sim.set_positions(pos, box=box, spread=0.002 if n_beads > 1 else 0.0)
    rows = sim.step(n_steps, report_interval=report_interval(n_steps, interval),
                    check_health=check_health)
    rho, total_mass = density(sim, rows)
    tail = rho[len(rho) // 2:]
    ke = float(np.mean(rows['kinetic_virial'][len(rows['volume']) // 2:]))
    tag = f'{isotope} {"classical" if n_beads == 1 else f"{n_beads}-bead"}'
    out = dict(rho=float(tail.mean()), rho_err=float(tail.std() / max(np.sqrt(len(tail)), 1)),
               volumes=np.asarray(rows['volume']), ke_virial_kj=ke,
               moves_attempted=int(rows['barostat_attempted']),
               moves_accepted=int(rows['barostat_accepted']), captured=sim.captured,
               captures=len(sim.capture_ms), total_mass=total_mass)
    if echo:
        print(f'{tag:22s} rho = {out["rho"]:.4f} +- {out["rho_err"]:.4f} g/cm^3   '
              f'(V: {rows["volume"][0]:.2f} -> {rows["volume"][-1]:.2f} nm^3, '
              f'<KE_cv> = {ke:.0f} kJ/mol)')
    return out


def run(n_steps=2000, n_beads=8, interval=25, classical=False, device='cuda', check_health=True,
        echo=True):
    """H2O and D2O (and, with classical, both at n_beads = 1); returns each
    run's readings and the density ratios."""
    say = print if echo else (lambda *a, **k: None)
    say(f'NPT {T} K, {P_BAR} bar, water256 PME, dt = {DT * 1e3} fs, {n_steps} steps, volume '
        f'move every {interval}')
    out = {iso: run_one(iso, n_beads, n_steps, interval, device, check_health, echo)
           for iso in ('H2O', 'D2O')}
    h, d = out['H2O'], out['D2O']
    out['ratio'] = d['rho'] / h['rho']
    out['mass_ratio'] = d['total_mass'] / h['total_mass']
    out['molar_volume_effect'] = out['ratio'] / out['mass_ratio'] - 1.0
    say(f'quantum rho(D2O)/rho(H2O)   = {out["ratio"]:.4f}   (mass ratio alone '
        f'{out["mass_ratio"]:.4f}; experiment 1.1077 at 25 C)')
    say(f'molar-volume isotope effect = {out["molar_volume_effect"]:+.4%} (NQE beyond the mass '
        'ratio)')
    if classical:
        hc = run_one('H2O', 1, n_steps, interval, device, check_health, echo)
        dc = run_one('D2O', 1, n_steps, interval, device, check_health, echo)
        out.update(classical_H2O=hc, classical_D2O=dc, classical_ratio=dc['rho'] / hc['rho'])
        say(f'classical rho(D2O)/rho(H2O) = {out["classical_ratio"]:.4f}   (= the mass ratio up '
            'to sampling noise: the classical NPT ensemble is mass-independent)')
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('n_steps', nargs='?', type=int, default=2000)
    ap.add_argument('--beads', type=int, default=8)
    ap.add_argument('--interval', type=int, default=25)
    ap.add_argument('--classical', action='store_true')
    cli.add_device_argument(ap)
    a = ap.parse_args(argv)
    run(a.n_steps, a.beads, a.interval, a.classical, a.device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
