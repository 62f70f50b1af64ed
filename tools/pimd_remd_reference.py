"""Reference readings of the path-integral phases of chip_smoke.py (20-22),
through the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tools/pimd_remd_reference.py [--what hamiltonian pressure stale]
        [--seeds 0 1 2] [--steps 200] [--out FILE]

hamiltonian  float32 Hamiltonian RPMD of the water256 fixture, the protocol
             of phase 21: MBPolConfig.for_dynamics(scf_method='sor') after
             tune_capacities(margin=1.3), PIMDSimulation(n_beads=8,
             dt=1e-4, temperature=300, thermostat='none', seed=s,
             nlist_rebuild_interval=25) (the ASPC closure along the
             trajectory), set_positions(spread=0.002), `--steps` steps with
             the lists rebuilt every 25 steps as PIMDSimulation's scan does.
             Per seed: the ring-polymer Hamiltonian at the start, after the
             first half and at the end, and the fitted change of it over
             the second half (slope x the half's steps, kJ/mol).
pressure     virial_pressure of the water256 fixture at 300 K (temperature
             form) under for_dynamics(scf_method='sor', target_epsilon=1e-8,
             scf_eps_floor=1e-6): float32, and float64 at the
             float32-rounded positions (the same input); the distance
             |P32 - P64| in bar, and dU/dlambda of each.
stale        rpmd_barostat_move at water50 (box 1.8 nm, cutoff 0.85 nm, 4
             beads, spread 0.002, float64), its energy function the
             converged per-bead evaluation: the first seed whose move is
             accepted; the largest |F| difference between the forces the
             returned state carries and a fresh evaluation at its
             positions and box (kJ/mol/nm).

Float32 runs with x64 off, float64 inside jax.enable_x64(True). The last
line is a JSON object of the readings.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FIXTURES = os.path.join(REPO, 'tests', 'fixtures')
FIXTURE = os.path.join(FIXTURES, 'water256_integration_test.npz')
BOX = 19.3996888399961804 / 10.0
T_K = 300.0
NL_EVERY = 25


def second_half_fit(h):
    """Fitted change of a per-step series over its second half (slope x the
    half's steps), index 0 = the start."""
    n = len(h) - 1
    half = np.asarray(h[n // 2:], np.float64)
    x = np.arange(len(half), dtype=np.float64)
    return float(np.polyfit(x, half, 1)[0] * (len(half) - 1))


def water256(dtype):
    import jax.numpy as jnp

    from mbpol_openmm_plugin_tpu.system import (System, compute_virtual_sites,
                                                make_molecules_whole)
    with np.load(FIXTURE) as z:
        system = System.from_atom_names(z['names'], z['resnames'], box=[BOX] * 3)
        pos = np.asarray(z['positions'], np.float32).astype(np.float64)
    pos = compute_virtual_sites(system, make_molecules_whole(system, jnp.asarray(pos, dtype)))
    return system, pos


def hamiltonian(readings, seeds, steps):
    import jax
    import jax.numpy as jnp

    from mbpol_openmm_plugin_tpu.md import rpmd as R
    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig

    system, pos = water256(jnp.float32)
    pot = MBPol(system, MBPolConfig.for_dynamics(scf_method='sor'))
    pot.tune_capacities(pos, margin=1.3)
    fits = []
    for seed in seeds:
        t0 = time.perf_counter()
        sim = R.PIMDSimulation(pot, n_beads=8, dt=1e-4, temperature=T_K, thermostat='none',
                               seed=seed, nlist_rebuild_interval=NL_EVERY)
        sim.set_positions(pos, spread=0.002)

        def build(q):
            return sim._nl_builder(sim._to_eval(q))

        def body(carry, i):
            s, (m, nl, ov) = carry

            def rebuild(args):
                nl2, ov2 = build(s.positions)
                return nl2, args[1] | ov2
            nl, ov = jax.lax.cond(i % NL_EVERY == 0, rebuild, lambda a: a, (nl, ov))
            s, a = sim._step(s, (m, nl, ov))
            return (s, a), R.ring_polymer_hamiltonian(system, s, T_K)

        nl, ov = jax.jit(build)(sim.state.positions)
        run = jax.jit(lambda s, a: jax.lax.scan(body, (s, a), jnp.arange(steps)))
        (state, (_, _, ov)), hs = run(sim.state, (sim._mu, nl, ov))
        h = np.concatenate([[float(R.ring_polymer_hamiltonian(system, sim.state, T_K))],
                            np.asarray(hs, np.float64)])
        fit = second_half_fit(h)
        fits.append(fit)
        print(f'seed {seed}: H {h[0]:.4f} -> {h[steps // 2]:.4f} -> {h[-1]:.4f} kJ/mol, '
              f'second-half fit {fit:+.4f} kJ/mol, finite {bool(np.all(np.isfinite(h)))}, '
              f'overflow {bool(np.any(np.asarray(ov)))} ({time.perf_counter() - t0:.1f} s)', flush=True)
    readings['hamiltonian_fits'] = fits
    readings['hamiltonian_steps'] = steps


def pressure(readings):
    import jax
    import jax.numpy as jnp

    from mbpol_openmm_plugin_tpu.md import pressure as PR
    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig

    cfg = MBPolConfig.for_dynamics(scf_method='sor', target_epsilon=1e-8, scf_eps_floor=1e-6,
                                   max_iterations=500)
    out = {}
    for name, dtype in (('f32', jnp.float32), ('f64', jnp.float64)):
        with jax.enable_x64(dtype == jnp.float64):
            t0 = time.perf_counter()
            system, pos = water256(dtype)
            pot = MBPol(system, cfg)
            pot.tune_capacities(pos)
            p = float(PR.virial_pressure(pot, pos, temperature_k=T_K))
            du = float(pot._virial_du_jit(pos, jnp.asarray(system.box, dtype)))
            out[name] = (p, du)
            print(f'{name}: P {p:.4f} bar, dU/dlambda {du:.4f} kJ/mol '
                  f'({time.perf_counter() - t0:.1f} s)', flush=True)
    d = abs(out['f32'][0] - out['f64'][0])
    print(f'|P32 - P64| {d:.4f} bar, |dU32 - dU64| {abs(out["f32"][1] - out["f64"][1]):.4f} '
          'kJ/mol', flush=True)
    readings['pressure_f32_bar'], readings['pressure_f64_bar'] = out['f32'][0], out['f64'][0]
    readings['pressure_f32_f64_bar'] = d


def stale(readings):
    import jax
    import jax.numpy as jnp

    from mbpol_openmm_plugin_tpu.md import rpmd as R
    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu.system import (System, compute_virtual_sites,
                                                make_molecules_whole)

    with jax.enable_x64(True):
        with np.load(os.path.join(FIXTURES, 'water50.npz')) as z:
            system = System.from_atom_names(z['names'], z['resnames'], box=[1.8] * 3)
            pos = jnp.asarray(np.array(z['positions']))
        pos = compute_virtual_sites(system, make_molecules_whole(system, pos))
        pot = MBPol(system, MBPolConfig(nonbonded_method='PME', cutoff=0.85,
                                        target_epsilon=1e-10, max_iterations=500))

        def ef(q, box):
            return jax.vmap(lambda p: pot._energy_forces_impl(p, box=box)[:2])(q)
        ef = jax.jit(ef)
        for seed in range(20):
            st = R.initial_state(system, pos, 4, T_K, jax.random.PRNGKey(seed), spread=0.002)
            e, f = ef(st.positions, st.box)
            st = dataclasses.replace(st, forces=f, potential_energy=e)
            new, acc = R.rpmd_barostat_move(system, lambda q, b: ef(q, b)[0], st, T_K, 1.0)
            if bool(acc):
                break
        _, f_new = ef(new.positions, new.box)
        gap = float(jnp.max(jnp.abs(new.forces - f_new)))
        print(f'water50, 4 beads, seed {seed}: accepted, box {float(st.box[0]):.6f} -> '
              f'{float(new.box[0]):.6f} nm; forces carried vs fresh: max |dF| {gap:.4f} '
              f'kJ/mol/nm (max |F| {float(jnp.max(jnp.abs(f_new))):.2f})', flush=True)
    readings['stale_force_seed'] = seed
    readings['stale_force_gap'] = gap


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--what', nargs='+', default=['hamiltonian', 'pressure', 'stale'])
    ap.add_argument('--seeds', type=int, nargs='+', default=[0, 1, 2])
    ap.add_argument('--steps', type=int, default=200)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    readings = {}
    if 'stale' in args.what:
        stale(readings)
    if 'pressure' in args.what:
        pressure(readings)
    if 'hamiltonian' in args.what:
        hamiltonian(readings, args.seeds, args.steps)
    line = json.dumps(readings)
    if args.out:
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    print(line)


if __name__ == '__main__':
    main()
