"""Path-integral MD of the water14 cluster (examples/water14_pimd.py on the
port, md/rpmd.py's functional API).

A PILE-thermostatted ring polymer (tau0 0.05 ps) of n_beads at 150 K, dt
0.1 fs, from the fixture with a 0.002 nm bead spread, every bead starting
with bead 0's forces; prints the centroid-virial quantum kinetic energy
(mean over the second half) against classical equipartition: at 150 K the
intramolecular modes are deeply quantum (KE_q >> 3/2 NkT).

The step is `make_rpmd_potential_step` (or, with n_contract,
`make_rpmd_contracted_potential_step`), each evaluated bead a converged
cluster evaluation; the loop runs eagerly (see water256_pimd), and its
steps/s is timed over the steps after the first (synchronized).

    python -m mbpol_openmm_plugin_tpu_torch.examples.water14_pimd [n_beads] [n_steps] [n_contract]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from mbpol_openmm_plugin_tpu_torch.examples import _common
from mbpol_openmm_plugin_tpu_torch.examples.water256_pimd import generator_normals, trajectory
from mbpol_openmm_plugin_tpu_torch.utils import cli

T = 150.0
DT = 1e-4          # ps (0.1 fs; OH stretch ~ 10 fs period)
TAU0 = 0.05


def potential(device='cuda'):
    """(system, MBPol of the water14 cluster fixture (NoCutoff, eps 1e-5),
    positions with the M sites placed)."""
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.system import System, compute_virtual_sites
    sys_ = System.waters(14)
    pot = MBPol(sys_, MBPolConfig(nonbonded_method='NoCutoff', target_epsilon=1e-5),
                device=cli.device(device))
    pos = compute_virtual_sites(sys_, pot.as_positions(
        cli.load_fixture('water14_cluster')['positions']))
    return sys_, pot, pos


def start(pot, pos, n_beads, n_contract, normal):
    """(step(state, noise), the start): the beads spread by 0.002 x normals,
    each with bead 0's energy and forces."""
    from mbpol_openmm_plugin_tpu_torch.md import rpmd
    if n_contract:
        step = rpmd.make_rpmd_contracted_potential_step(pot, n_beads, n_contract, DT, T,
                                                        tau0=TAU0)
    else:
        step = rpmd.make_rpmd_potential_step(pot, n_beads, DT, T, tau0=TAU0)
    state = rpmd.initial_state(pot.system, pos, n_beads, T, spread=0.002,
                               normals=normal((n_beads,) + tuple(pos.shape), pos))
    e, f, _, _ = pot._energy_forces_impl(state.positions[0])
    return step, dataclasses.replace(
        state, forces=f[None].expand_as(state.positions).clone(),
        potential_energy=e[None].expand(n_beads).clone())


def run(n_beads=8, n_steps=400, n_contract=0, device='cuda', normal=None, echo=True):
    """The script's run; returns steps/s, the bead-mean PE, KE_q, the
    classical KE (kcal/mol) and their ratio."""
    from mbpol_openmm_plugin_tpu_torch.utils import units
    say = print if echo else (lambda *a, **k: None)
    sys_, pot, pos = potential(device)
    normal = normal or generator_normals(pot.device)
    step, state = start(pot, pos, n_beads, n_contract, normal)
    t_all = time.perf_counter()
    state, _, k1 = trajectory(sys_, step, state, 1, T, normal)
    _common.sync(pot.device)
    t0 = time.perf_counter()
    state, _, kes = trajectory(sys_, step, state, n_steps - 1, T, normal)
    _common.sync(pot.device)
    now = time.perf_counter()
    kes = [float(k) for k in k1] + [float(k) for k in kes]
    kT = units.BOLTZMANN_KJ_MOL_K * T
    ke_cl = 1.5 * 3 * 14 * kT
    burn = n_steps // 2
    ke_q = sum(kes[burn:]) / len(kes[burn:])
    out = dict(wall_s=now - t_all, steps_per_second=(n_steps - 1) / (now - t0),
               pe_bead_mean_kcal=float(state.potential_energy.mean()) / 4.184,
               ke_q_kcal=ke_q / 4.184, ke_classical_kcal=ke_cl / 4.184,
               ratio=ke_q / ke_cl, ke_virial=kes)
    say(f'{n_beads} beads x {n_steps} steps in {out["wall_s"]:.1f} s '
        f'({out["steps_per_second"]:.1f} steps/s after the first)')
    say(f'potential energy (bead mean): {out["pe_bead_mean_kcal"]:.2f} kcal/mol')
    say(f'quantum KE (centroid-virial): {out["ke_q_kcal"]:.2f} kcal/mol')
    say(f'classical equipartition KE:   {out["ke_classical_kcal"]:.2f} kcal/mol')
    say(f'quantum/classical ratio:      {out["ratio"]:.2f}  '
        f'(zero-point motion of the OH stretches)')
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('n_beads', nargs='?', type=int, default=8)
    ap.add_argument('n_steps', nargs='?', type=int, default=400)
    # optional ring-polymer contraction (odd; the intermolecular terms on
    # this many beads, the monomer term on all)
    ap.add_argument('n_contract', nargs='?', type=int, default=0)
    cli.add_device_argument(ap)
    a = ap.parse_args(argv)
    run(a.n_beads, a.n_steps, a.n_contract, a.device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
