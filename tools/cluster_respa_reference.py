"""Reference readings behind chip_smoke.py phases 16-18 (the cluster path and
r-RESPA of the PyTorch port), through the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tools/cluster_respa_reference.py \
        [--what single droplet_md respa_md gaps water14_langevin] [--chunks 3]
        [--seeds 0 1 2] [--out FILE]

single      float32 against float64 single points of the JAX MBPol, both at
            the float32-rounded positions (the same input): the
            water14 cluster (tests/fixtures/water14_cluster.npz) and the
            water256 droplet (the water256 integration fixture made whole
            in its box, then evaluated without a box, after
            tune_capacities), MBPolConfig(nonbonded_method='NoCutoff',
            cutoff=0.9): per term |E32 - E64| (kJ/mol) and max |F32 - F64|
            / max |F64|; SOR and DIIS iteration counts; at the droplet the
            system moments (max |d| / max |m64|) and the potential at 64
            points on a sphere of 2.0 nm about the oxygen centroid (max
            |d|, kJ/mol/e); and the water256 PME single point of phase 4
            (eps 1e-4): |E32 - E64| of the electrostatics under SOR, and
            DIIS - SOR at float32.
droplet_md  float32 NVE of the droplet under for_dynamics(nonbonded_method=
            'NoCutoff'), velocity Verlet at 0.2 fs from rest, ASPC (k = 3)
            seeded from a converged evaluation at each chunk's start,
            lists rebuilt on the displacement trigger: per chunk of 200
            steps the change of E_tot fitted over its second half (as
            tools/md_gate_reference.py). Chunks start at steps 0, 200, 400.
respa_md    the same for two-level r-RESPA on water256 PME (for_dynamics,
            respa_inner 2, outer dt 0.4 fs, chunks of 100 outer steps): the
            port's Simulation protocol, with the slow rung's forces seeded
            at each chunk's start from the ASPC predictor.
gaps        the JAX package's own faults on the port's test inputs:
            three-level RESPA on the water3 cluster ('inner' and 'mid', 10
            outer steps) with nlist_rebuild_interval=2 (five groups)
            against 1 (one group), max |d position| and |d PE|; and the
            water14 cluster stored as H1, O, M, H2 per water against the
            standard layout, |d E| of the electrostatics.
water14_langevin
            phase 17's water14 protocol through the JAX Simulation in
            float32: MBPolConfig(nonbonded_method='NoCutoff',
            target_epsilon=1e-3, restraint_radius=0.75, restraint_k=1000),
            Langevin 300 K at 1/ps, 0.2 fs, set_velocities_to_temperature(300)
            from each --seeds seed, 500 steps in reports of 100; per seed the
            kinetic temperature after step 1 and its mean over steps
            251..500 (every step's, read by a callback inside the chunk).

Float32 runs with x64 off, float64 inside jax.enable_x64(True). The
last line is a JSON object of every reading.
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
sys.path.insert(0, os.path.join(REPO, 'tests'))

FIXTURE = os.path.join(REPO, 'tests', 'fixtures', 'water256_integration_test.npz')
BOX = 19.3996888399961804 / 10.0
CLUSTER = dict(nonbonded_method='NoCutoff', cutoff=0.9)
PME_SINGLE_POINT = dict(nonbonded_method='PME', cutoff=0.9, target_epsilon=1e-4,
                        nlist_skin=0.02, max_iterations=200)
GRID_RADIUS = 2.0
N_GRID = 64
DT = 0.0002
DROPLET_CHUNK = 200
RESPA_CHUNK, RESPA_INNER = 100, 2


def second_half_fit(e_tot):
    half = np.asarray(e_tot[(len(e_tot) - 1) // 2:], np.float64)
    return float(np.polyfit(np.arange(len(half), dtype=np.float64), half, 1)[0]
                 * (len(half) - 1))


def sphere_points(center, radius, n):
    """n points on a sphere (Fibonacci lattice)."""
    k = np.arange(n) + 0.5
    phi = np.arccos(1.0 - 2.0 * k / n)
    theta = np.pi * (1.0 + 5 ** 0.5) * k
    return center + radius * np.stack([np.cos(theta) * np.sin(phi),
                                       np.sin(theta) * np.sin(phi), np.cos(phi)], axis=1)


def whole_with_m_sites(system, pos, box=None):
    """float64 numpy positions of a stride-4 water layout with each water's
    H1, H2 imaged next to its O in `box` (the JAX make_molecules_whole
    formula) and the M sites placed (average3 weights)."""
    from mbpol_openmm_plugin_tpu import data
    p4 = np.array(pos, np.float64).reshape(system.n_waters, 4, 3)
    if box is not None:
        box = np.asarray(box, np.float64)
        p4[:, 1:] += np.floor((p4[:, :1] - p4[:, 1:]) / box + 0.5) * box
    w = np.asarray(data.load('forcefield')['vsite_weights'], np.float64)
    p4[:, 3] = w[0] * p4[:, 0] + w[1] * p4[:, 1] + w[2] * p4[:, 2]
    return p4.reshape(-1, 3)


def load_inputs():
    """{name: (System, positions float64 numpy with M placed)}: the water14
    cluster and the water256 droplet (no box)."""
    import fixtures

    from mbpol_openmm_plugin_tpu.system import System
    d = fixtures.load('water14_cluster')
    sys14 = System.from_atom_names(d['names'], d['resnames'])
    with np.load(FIXTURE) as z:
        droplet = System.from_atom_names(z['names'], z['resnames'])
        pos = whole_with_m_sites(droplet, z['positions'], [BOX] * 3)
    return {'water14_cluster': (sys14, whole_with_m_sites(sys14, d['positions'])),
            'water256_droplet': (droplet, pos)}


def evaluate(system, pos, dtype, tune=True, **cfg):
    """(per-term energies, forces, diag, potential) of a JAX MBPol."""
    import jax.numpy as jnp

    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
    pot = MBPol(system, MBPolConfig(**cfg))
    p = jnp.asarray(pos, dtype)
    if tune and pot.use_neighbor_lists:
        pot.tune_capacities(p)
    e, f, parts, diag = pot.energy_forces(p)
    return ({k: float(v) for k, v in parts.items()}, np.asarray(f, np.float64), diag, pot)


def single(readings):
    import jax
    import jax.numpy as jnp

    from mbpol_openmm_plugin_tpu.models import electrostatics as elec
    from mbpol_openmm_plugin_tpu.system import System

    for name, (system, pos) in load_inputs().items():
        # float64 at the float32 positions: the same input on both sides
        pos = pos.astype(np.float32).astype(np.float64)
        p32, f32, d32, pot32 = evaluate(system, pos, jnp.float32, **CLUSTER)
        _, _, dd32, _ = evaluate(system, pos, jnp.float32, scf_method='diis', **CLUSTER)
        with jax.enable_x64(True):
            p64, f64, d64, _ = evaluate(system, pos, jnp.float64, **CLUSTER)
            _, _, dd64, _ = evaluate(system, pos, jnp.float64, scf_method='diis', **CLUSTER)
        row = dict(terms={k: abs(p32[k] - p64[k]) for k in p64},
                   total=abs(sum(p32.values()) - sum(p64.values())),
                   forces_rel=float(np.max(np.abs(f32 - f64)) / np.max(np.abs(f64))),
                   sor_iterations_f32=int(d32['iterations']),
                   diis_iterations_f32=int(dd32['iterations']),
                   sor_iterations_f64=int(d64['iterations']),
                   diis_iterations_f64=int(dd64['iterations']))
        print(f'{name}: |E32 - E64| per term (kJ/mol) '
              + ', '.join(f'{k} {v:.6f}' for k, v in row['terms'].items())
              + f'; total {row["total"]:.6f}; forces max |dF| / max |F| {row["forces_rel"]:.3e}; '
              f'SOR / DIIS iterations f32 {row["sor_iterations_f32"]} / '
              f'{row["diis_iterations_f32"]}, f64 {row["sor_iterations_f64"]} / '
              f'{row["diis_iterations_f64"]}', flush=True)
        if name == 'water256_droplet':
            params32 = pot32.elec_params
            center = pos[system.o_index].mean(axis=0)
            grid = sphere_points(center, GRID_RADIUS, N_GRID)
            grid = grid.astype(np.float32).astype(np.float64)
            m32 = np.asarray(elec.system_moments(params32, jnp.asarray(pos, jnp.float32),
                                                 system.masses), np.float64)
            g32 = np.asarray(elec.electrostatic_potential_on_grid(
                params32, jnp.asarray(pos, jnp.float32), jnp.asarray(grid, jnp.float32)))
            with jax.enable_x64(True):
                params64 = elec.ElecParams.for_system(system)
                m64 = np.asarray(elec.system_moments(params64, jnp.asarray(pos), system.masses))
                g64 = np.asarray(elec.electrostatic_potential_on_grid(
                    params64, jnp.asarray(pos), jnp.asarray(grid)))
            row.update(moments_rel=float(np.max(np.abs(m32 - m64)) / np.max(np.abs(m64))),
                       grid_abs=float(np.max(np.abs(g32 - g64))),
                       grid_max=float(np.max(np.abs(g64))))
            print(f'  moments max |d| / max |m| {row["moments_rel"]:.3e}; potential on '
                  f'{N_GRID} points at {GRID_RADIUS} nm: max |d| {row["grid_abs"]:.6f} kJ/mol/e '
                  f'(max |phi| {row["grid_max"]:.4f})', flush=True)
        readings[name] = row

    with np.load(FIXTURE) as z:
        system = System.from_atom_names(z['names'], z['resnames'], box=[BOX] * 3)
        pos = whole_with_m_sites(system, z['positions'], system.box)
    pos = pos.astype(np.float32).astype(np.float64)
    terms = ('electrostatics',)
    p32, _, d32, _ = evaluate(system, pos, jnp.float32, tune=False, terms=terms,
                              **PME_SINGLE_POINT)
    q32, _, dq32, _ = evaluate(system, pos, jnp.float32, tune=False, terms=terms,
                               scf_method='diis', **PME_SINGLE_POINT)
    with jax.enable_x64(True):
        p64, _, d64, _ = evaluate(system, pos, jnp.float64, tune=False, terms=terms,
                                  **PME_SINGLE_POINT)
    row = dict(elec_f32_f64=abs(p32['electrostatics'] - p64['electrostatics']),
               diis_minus_sor_f32=q32['electrostatics'] - p32['electrostatics'],
               sor_iterations_f32=int(d32['iterations']),
               diis_iterations_f32=int(dq32['iterations']),
               sor_iterations_f64=int(d64['iterations']))
    print(f'water256 PME (eps 1e-4): electrostatics |E32 - E64| {row["elec_f32_f64"]:.6f} '
          f'kJ/mol; DIIS - SOR at f32 {row["diis_minus_sor_f32"]:+.6f} kJ/mol; iterations SOR '
          f'{row["sor_iterations_f32"]} / DIIS {row["diis_iterations_f32"]} (f32), SOR '
          f'{row["sor_iterations_f64"]} (f64)', flush=True)
    readings['water256_pme'] = row


def nve_chunks(system, pot, pos, n_chunks, chunk, respa_inner=1):
    """float32 NVE from rest in chunks (the port's Simulation protocol):
    per chunk the second-half fit of E_tot per (outer) step."""
    import jax
    import jax.numpy as jnp

    from mbpol_openmm_plugin_tpu.md import integrators as I
    from mbpol_openmm_plugin_tpu.md.rpmd import mbpol_intra_inter_split
    from mbpol_openmm_plugin_tpu.models import electrostatics as elec

    full = jax.jit(pot._energy_forces_impl)
    if respa_inner > 1:
        ef_intra, ef_inter = mbpol_intra_inter_split(pot)
        slow_pot = ef_inter._potential
        intra = jax.jit(lambda p: ef_intra(p))
    else:
        slow_pot = pot
    slow = jax.jit(slow_pot._energy_forces_impl)
    masses = np.asarray(system.masses)
    m = jnp.asarray(masses, jnp.float32)[:, None]
    B = jnp.asarray(elec.aspc_predictor_coefficients(pot.config.aspc_k), jnp.float32)
    skin = pot.config.nlist_skin
    o = np.asarray(system.o_index)
    pos = jnp.asarray(pos, jnp.float32)
    e, f, _, _ = full(pos)
    v = jnp.zeros_like(pos)
    fits = []
    t0 = time.perf_counter()
    for c in range(n_chunks):
        hist = jnp.tile(full(pos)[3]['induced_dipoles'][None], (len(B), 1, 1))
        nl_box = [slow_pot.build_neighbor_lists(pos)[0], pos]

        def ef_slow(p):
            nonlocal hist
            disp = float(jnp.max(jnp.linalg.norm(p[o] - nl_box[1][o], axis=-1)))
            if 2.0 * disp > 0.5 * skin:
                nl_box[:] = [slow_pot.build_neighbor_lists(p)[0], p]
            e_, f_, _, d_ = slow(p, jnp.einsum('h,hnd->nd', B, hist), nlists=nl_box[0])
            hist = jnp.roll(hist, 1, axis=0).at[0].set(d_['induced_dipoles'])
            return e_, f_

        state = I.MDState(positions=pos, velocities=v, forces=f, potential_energy=e,
                          box=jnp.zeros(3, jnp.float32), step=jnp.zeros((), jnp.int32),
                          rng=jax.random.PRNGKey(0))
        if respa_inner > 1:
            # the slow rung's seed at the chunk's start: the predictor, no push
            f_slow = slow(pos, jnp.einsum('h,hnd->nd', B, hist), nlists=nl_box[0])[1]
        e_tot = [float(e) + float(0.5 * jnp.sum(m * v * v))]
        for _ in range(chunk):
            if respa_inner > 1:
                state, f_slow, _ = I.respa_velocity_verlet_step(
                    system, intra, ef_slow, state, f_slow, RESPA_INNER * DT, respa_inner)
            else:
                state = I.velocity_verlet_step(system, ef_slow, state, DT)
            e_tot.append(float(state.potential_energy)
                         + float(0.5 * jnp.sum(m * state.velocities ** 2)))
        pos, v, f, e = state.positions, state.velocities, state.forces, state.potential_energy
        fit = second_half_fit(e_tot)
        fits.append(fit)
        print(f'  chunk {c}: E_tot {e_tot[0]:.4f} -> {e_tot[-1]:.4f} kJ/mol; second-half fit '
              f'{fit:+.4f} kJ/mol ({time.perf_counter() - t0:.0f} s)', flush=True)
    return fits


def droplet_md(readings, n_chunks):
    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
    system, pos = load_inputs()['water256_droplet']
    pot = MBPol(system, MBPolConfig.for_dynamics(nonbonded_method='NoCutoff'))
    pot.tune_capacities(np.asarray(pos, np.float32))
    print(f'water256 droplet NVE, {DROPLET_CHUNK}-step chunks (float32):', flush=True)
    readings['droplet_md_fits'] = nve_chunks(system, pot, pos, n_chunks, DROPLET_CHUNK)


def respa_md(readings, n_chunks):
    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu.system import System
    with np.load(FIXTURE) as z:
        system = System.from_atom_names(z['names'], z['resnames'], box=[BOX] * 3)
        pos = whole_with_m_sites(system, z['positions'], system.box)
    pot = MBPol(system, MBPolConfig.for_dynamics())
    print(f'water256 PME two-level RESPA NVE (inner {RESPA_INNER}, outer dt '
          f'{RESPA_INNER * DT * 1e3:.1f} fs), {RESPA_CHUNK}-outer-step chunks (float32):',
          flush=True)
    readings['respa_md_fits'] = nve_chunks(system, pot, pos, n_chunks, RESPA_CHUNK,
                                           respa_inner=RESPA_INNER)


def gaps(readings):
    import fixtures
    import jax
    import jax.numpy as jnp

    from mbpol_openmm_plugin_tpu.md import integrators as I
    from mbpol_openmm_plugin_tpu.md.simulation import Simulation, SimulationConfig
    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu.system import System
    with jax.enable_x64(True):
        sys3, pos3 = fixtures.load_system('water3')
        vel = I.maxwell_boltzmann_velocities(sys3, 300.0, jax.random.PRNGKey(7), jnp.float64)
        for rung in ('inner', 'mid'):
            runs = []
            for interval in (2, 1):
                sim = Simulation(MBPol(sys3, MBPolConfig(**CLUSTER)), SimulationConfig(
                    dt=0.0008, respa_inner=2, respa_mid=2, respa_polarization_rung=rung,
                    nlist_rebuild_interval=interval))
                sim.set_positions(pos3)
                sim.state = dataclasses.replace(sim.state, velocities=vel)
                state, _, pes, _, _ = sim._step_chunk(sim.state, None, n_steps=10)
                runs.append((np.asarray(state.positions), np.asarray(pes)))
            dpos = float(np.max(np.abs(runs[0][0] - runs[1][0])))
            dpe = float(np.max(np.abs(runs[0][1] - runs[1][1])))
            readings[f'carry_gap_{rung}'] = dict(positions=dpos, pe=dpe)
            print(f'three-level RESPA ({rung!r}), water3 float64, 10 outer steps, list interval '
                  f'2 (five groups) vs 1 (one group): max |d pos| {dpos:.3e} nm, max |d PE| '
                  f'{dpe:.3e} kJ/mol', flush=True)

        d = fixtures.load('water14_cluster')
        std = System.from_atom_names(d['names'], d['resnames'])
        sys14, pos14 = fixtures.load_system('water14_cluster')
        order = np.array([1, 0, 3, 2])      # H1, O, M, H2
        perm = (4 * np.arange(std.n_waters)[:, None] + order[None, :]).reshape(-1)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        new = dataclasses.replace(
            std, atom_class=std.atom_class[perm], mol_index=std.mol_index[perm],
            masses=std.masses[perm], o_index=inv[std.o_index], h1_index=inv[std.h1_index],
            h2_index=inv[std.h2_index], m_index=inv[std.m_index])
        cfg = MBPolConfig(terms=('electrostatics',), **CLUSTER)
        e_std = float(MBPol(std, cfg).energy_forces(pos14)[0])
        e_new = float(MBPol(new, cfg).energy_forces(jnp.asarray(pos14)[perm])[0])
    readings['layout_gap_elec'] = e_new - e_std
    print(f'water14 cluster stored as H1, O, M, H2: electrostatics {e_new:.6f} against '
          f'{e_std:.6f} kJ/mol in the standard layout ({e_new - e_std:+.6f})', flush=True)


WATER14_MD = dict(nonbonded_method='NoCutoff', target_epsilon=1e-3, max_iterations=200,
                  restraint_radius=0.75, restraint_k=1000.0)
WATER14_STEPS, WATER14_REPORT, WATER14_T_K, WATER14_FRICTION = 500, 100, 300.0, 1.0


def water14_langevin(readings, seeds):
    import jax

    from mbpol_openmm_plugin_tpu.md import integrators as I
    from mbpol_openmm_plugin_tpu.md.simulation import Simulation, SimulationConfig
    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
    system, pos = load_inputs()['water14_cluster']
    ndof = 3 * int(np.sum(np.asarray(system.masses) > 0))
    kb = 0.00831446261815324
    ke = {}

    class Recording(Simulation):
        """The JAX Simulation with every step's kinetic energy sent to the
        host by a callback (the chunk reports only its last)."""
        def _maybe_remove_cm(self, state):
            state = super()._maybe_remove_cm(state)
            jax.debug.callback(lambda s, k: ke.__setitem__(int(s), float(k)), state.step,
                               I.kinetic_energy(self.system, state.velocities))
            return state

    pot = MBPol(system, MBPolConfig(**WATER14_MD))
    cfg = SimulationConfig(dt=DT, temperature=WATER14_T_K, thermostat='langevin',
                           friction=WATER14_FRICTION)
    runs = []
    print(f'water14 cluster under the restraint, Langevin {WATER14_T_K} K at '
          f'{WATER14_FRICTION}/ps, {WATER14_STEPS} steps (float32):', flush=True)
    for seed in seeds:
        ke.clear()
        sim = Recording(pot, cfg, seed=seed)
        sim.set_positions(np.asarray(pos, np.float32))
        sim.set_velocities_to_temperature(WATER14_T_K)
        t_start = 2.0 * float(I.kinetic_energy(system, sim.state.velocities)) / (ndof * kb)
        sim.step(WATER14_STEPS, report_interval=WATER14_REPORT)
        jax.effects_barrier()
        t = np.array([ke[k] for k in range(1, WATER14_STEPS + 1)]) * 2.0 / (ndof * kb)
        row = dict(seed=seed, t_start=t_start, t_step1=float(t[0]),
                   mean_t_second_half=float(np.mean(t[WATER14_STEPS // 2:])),
                   mean_t_first_half=float(np.mean(t[:WATER14_STEPS // 2])))
        runs.append(row)
        print(f'  seed {seed}: T from the draw {t_start:.2f} K, after step 1 {t[0]:.2f} K; '
              f'mean T over steps 1..{WATER14_STEPS // 2} {row["mean_t_first_half"]:.2f} K, '
              f'over {WATER14_STEPS // 2 + 1}..{WATER14_STEPS} '
              f'{row["mean_t_second_half"]:.2f} K', flush=True)
    readings['water14_langevin'] = runs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--what', nargs='+', default=['single', 'droplet_md', 'respa_md', 'gaps'],
                    choices=['single', 'droplet_md', 'respa_md', 'gaps', 'water14_langevin'])
    ap.add_argument('--chunks', type=int, default=3)
    ap.add_argument('--seeds', type=int, nargs='+', default=[0, 1, 2])
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    import jax
    readings = dict(platform='cpu', jax=jax.__version__)
    for what in args.what:
        t0 = time.perf_counter()
        {'single': lambda: single(readings),
         'droplet_md': lambda: droplet_md(readings, args.chunks),
         'respa_md': lambda: respa_md(readings, args.chunks),
         'gaps': lambda: gaps(readings),
         'water14_langevin': lambda: water14_langevin(readings, args.seeds)}[what]()
        print(f'({what}: {time.perf_counter() - t0:.0f} s)', flush=True)
    line = json.dumps(readings)
    if args.out:
        with open(args.out, 'w') as fh:
            fh.write(line + '\n')
    print(line)


if __name__ == '__main__':
    main()
