"""Bulk-water PIMD at near-classical cost: water256 PME, 8 beads, RPC
(examples/water256_pimd.py on the port).

Ring-polymer contraction (md/rpmd.py) evaluates the intermolecular terms on
the bead centroid (n_c = 1) and only the Partridge-Schwenke monomer term on
all 8 beads. Compares the MD throughput of classical dynamics (the n = 1
limit of the same integrator), 8-bead PIMD contracted to the centroid and,
with --full, 8 full beads, all with the same potential (PME, 0.9 nm cutoff,
SCF at 1e-3) and lists built in every evaluation, and prints the
centroid-virial kinetic energy (zero-point motion: KE_q >> 3/2 NkT).

Each configuration runs the script's loop twice from one start: a warm-up
pass of n_steps, then the timed pass of n_steps (synchronized before and
after). A step is the functional API's `make_rpmd_potential_step` /
`make_rpmd_contracted_potential_step` followed by the centroid-virial
estimator; its evaluations are converged ones (the SOR loop from zero
dipoles), as in the script's scan. Such an evaluation reads its stop test on
the host, so the loop runs eagerly, as PIMDSimulation runs every closure
but the warm ASPC one it captures. The O step's normals come from one
torch.Generator (seed 0), drawn before each step.

    python -m mbpol_openmm_plugin_tpu_torch.examples.water256_pimd [n_steps] [--full] [--d2o]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from mbpol_openmm_plugin_tpu_torch.examples import _common
from mbpol_openmm_plugin_tpu_torch.utils import cli

T = 300.0
DT = 2e-4                      # ps (0.2 fs, the reference benchmark step)
TAU0 = 0.1


def generator_normals(device, seed=0):
    """normal(shape) -> standard normals from one torch.Generator."""
    import torch
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def normal(shape, like):
        return torch.randn(shape, generator=gen, dtype=like.dtype, device=like.device)
    return normal


def ring_polymer(pot, pos, n_beads, n_contract, temperature, dt, tau0, normal, box=None,
                 spread=0.002):
    """(step(state, noise), the start: every bead at pos (spread x normals on
    the real atoms when n_beads > 1) with the energies and forces of
    `ef_all`), the script's set-up of one configuration."""
    import torch

    from mbpol_openmm_plugin_tpu_torch.md import rpmd

    if n_contract:
        step = rpmd.make_rpmd_contracted_potential_step(pot, n_beads, n_contract, dt,
                                                        temperature, tau0=tau0)
        ef_intra, pot_inter = rpmd.mbpol_intra_inter_split(pot)
        ef_all = rpmd.contracted_energy_forces(
            lambda p: pot_inter._energy_forces_impl(p)[:2], ef_intra, n_beads, n_contract)
    else:
        step = rpmd.make_rpmd_potential_step(pot, n_beads, dt, temperature, tau0=tau0)

        def ef_all(q):
            out = [pot._energy_forces_impl(p)[:2] for p in q]
            return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])
    sp = spread if n_beads > 1 else 0.0
    normals = normal((n_beads,) + tuple(pos.shape), pos) if sp > 0.0 else None
    state = rpmd.initial_state(pot.system, pos, n_beads, temperature, box=box, spread=sp,
                               normals=normals)
    e0, f0 = ef_all(state.positions)
    return step, dataclasses.replace(state, forces=f0, potential_energy=e0)


def trajectory(system, step, state, n_steps, temperature, normal):
    """n_steps of the script's chunk (a step, then the centroid-virial KE):
    (state, bead-summed PE [n_steps], KE_virial [n_steps]) as tensors."""
    import torch

    from mbpol_openmm_plugin_tpu_torch.md import rpmd
    pes, kes = [], []
    shape = tuple(state.positions.shape)
    for _ in range(n_steps):
        state = step(state, normal(shape, state.positions))
        kes.append(rpmd.kinetic_energy_virial(system, state.positions, state.forces, temperature))
        pes.append(torch.sum(state.potential_energy))
    return state, torch.stack(pes), torch.stack(kes)


def measure(sys_, pot, pos, box, tag, n_beads, n_steps, n_contract=None, echo=True):
    """One configuration: the warm-up pass, then the timed pass. Returns
    steps/s, ms/step, KE_virial (kcal/mol, mean over the timed pass's second
    half), the classical 3/2 NkT and the last bead-summed PE."""
    from mbpol_openmm_plugin_tpu_torch.utils import units
    normal = generator_normals(pot.device)
    step, state = ring_polymer(pot, pos, n_beads, n_contract, T, DT, TAU0, normal, box=box)
    state, _, _ = trajectory(sys_, step, state, n_steps, T, normal)     # warm-up
    _common.sync(pot.device)
    t0 = time.perf_counter()
    state, pes, kes = trajectory(sys_, step, state, n_steps, T, normal)
    _common.sync(pot.device)
    wall = time.perf_counter() - t0
    kT = units.BOLTZMANN_KJ_MOL_K * T
    n_real = 3 * sys_.n_waters
    ke_q = float(kes[n_steps // 2:].mean()) / 4.184
    out = dict(steps_per_second=n_steps / wall, ms_per_step=1e3 * wall / n_steps,
               ke_virial_kcal=ke_q, classical_kcal=1.5 * n_real * kT / 4.184,
               pe_last=float(pes[-1]))
    if echo:
        print(f'{tag:28s} {out["steps_per_second"]:7.1f} steps/s '
              f'({out["ms_per_step"]:6.2f} ms/step)  KE_virial {ke_q:7.1f} kcal/mol  '
              f'(classical 3/2 NkT = {out["classical_kcal"]:.1f})')
    if not np.isfinite(out['pe_last']):
        raise RuntimeError(f'{tag}: the potential energy is not finite')
    return out


def run(n_steps=100, full=False, isotope='H2O', device='cuda', echo=True):
    """classical, 8 -> 1 and (full) 8 full beads; returns each one's
    readings and the overheads against classical."""
    say = print if echo else (lambda *a, **k: None)
    sys_, pot, pos, box = _common.water_potential(device, isotope)
    out = dict(classical=measure(sys_, pot, pos, box, 'classical (n=1)', 1, n_steps, echo=echo))
    out['rpc'] = measure(sys_, pot, pos, box, 'PIMD 8 beads, RPC -> 1', 8, n_steps, 1, echo=echo)
    out['rpc_overhead'] = out['classical']['steps_per_second'] / out['rpc']['steps_per_second']
    say(f'quantum dynamics overhead with contraction: {out["rpc_overhead"]:.2f}x')
    if full:
        out['full'] = measure(sys_, pot, pos, box, 'PIMD 8 beads, full', 8, n_steps, echo=echo)
        out['full_overhead'] = (out['classical']['steps_per_second']
                                / out['full']['steps_per_second'])
        say(f'full-bead overhead: {out["full_overhead"]:.2f}x')
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('n_steps', nargs='?', type=int, default=100)
    ap.add_argument('--full', action='store_true')
    ap.add_argument('--d2o', action='store_true', help='heavy water: same PES, heavier masses')
    cli.add_device_argument(ap)
    a = ap.parse_args(argv)
    run(a.n_steps, a.full, 'D2O' if a.d2o else 'H2O', a.device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
