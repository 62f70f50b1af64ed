"""Where the time of an MD step goes, on one CUDA card.

    python -m mbpol_openmm_plugin_tpu_torch.tools.step_breakdown [--waters 256 4096]
        [--pip-impl IMPL] [--compact-eval {none,true,rebuild}] [--reps 10] [--steps 20]
        [--out FILE]

At the production operating point (MBPolConfig.for_dynamics(), float32)
on the tests/fixtures water256 box (analytic list capacities, dense
electrostatics) or on water4096, that box repeated 2 x 2 x 4 (after
tune_capacities; 'auto' picks block electrostatics and pair dispersion),
with the 2B/3B polynomials evaluated by --pip-impl (MBPolConfig.pip_impl;
default: the plain 'quad' evaluator) on the lists compacted as
--compact-eval says (MBPolConfig.compact_eval; default none), it reports:

1. pieces of one warm evaluation, each the median of --reps calls timed on
   the host clock around a synchronized call: the whole evaluation with
   prebuilt lists and an ASPC predictor, PME electrostatics, the DMS charges
   with dq/dr, the one-, two- and three-body terms and dispersion (forward
   and backward), the list builds, and the direct-space kernel wrapper
   calls (K1/K2, or K1-bs/K3-bs/K2-bs and the tile-pair list);
2. Simulation.step run for --steps and for 2 x --steps steps, once with
   every step run eagerly and once with each step replayed as a CUDA graph
   (Simulation.captured). The difference of the two runs is --steps steps
   without the fixed cost of a call (the converged evaluations at the
   chunk start and end): per step, its wall time (host clock, no
   profiler), the device kernels launched and their summed device time
   (the same two runs again under torch.profiler), and the device's busy
   share (summed kernel time over wall time; the kernels run on one
   stream, so they do not overlap). For the captured step also the
   capture time and one replay's device time from CUDA events (which is
   the device time to read if the profiler sees no kernel of a replay);
3. the device time of the 2B/3B list build that every captured 'auto'
   step makes before it selects between the new and the carried lists.

--waters takes one or both sizes. Prints a table per size and one JSON
object as the last line (also written to --out), with the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch.tools.timing import card_line

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIXTURE = os.path.join(REPO, 'tests', 'fixtures', 'water256_integration_test.npz')
BOX = 19.3996888399961804 / 10.0


def median_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _fwd_bwd(term, pos):
    def run():
        p = pos.clone().requires_grad_(True)
        torch.autograd.grad(term(p), p)
    return run


def pieces(pot, pos, reps):
    from mbpol_openmm_plugin_tpu_torch.models import electrostatics as elec
    from mbpol_openmm_plugin_tpu_torch.models import pme as pme_mod
    from mbpol_openmm_plugin_tpu_torch.models.dispersion import (dispersion_energy,
                                                                  dispersion_energy_pairs)
    from mbpol_openmm_plugin_tpu_torch.models.one_body import one_body_energy
    from mbpol_openmm_plugin_tpu_torch.models.three_body import three_body_energy
    from mbpol_openmm_plugin_tpu_torch.models.two_body import two_body_energy
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as BS
    from mbpol_openmm_plugin_tpu_torch.ops import neighbors
    from mbpol_openmm_plugin_tpu_torch.system import compute_virtual_sites, water_positions

    sys_, cfg, params = pot.system, pot.config, pot.elec_params
    pip = (cfg.pip_impl, cfg.pip_basis)
    (pl, tl), _ = pot.build_neighbor_lists(pos)
    mu0 = pot._energy_forces_impl(pos)[3]['induced_dipoles']
    pos_v = compute_virtual_sites(sys_, pos)
    charges, _ = elec.assemble_charges(params, pos_v)
    consts = ED.DirectConsts.from_setup(pot.pme, params.thole)
    dev = pos.device
    o_pos = pos[0::4]

    def no_grad(fn):
        def run():
            with torch.no_grad():
                fn()
        return run

    if pot.disp_mode == 'pairs':
        def disp_list():
            return neighbors.pair_list(o_pos, sys_.box, pot.water_pair_cut, pot.disp_pair_cap)
        mp, mp_mask, _ = disp_list()
        disp = ('dispersion fwd+bwd (pairs)', _fwd_bwd(
            lambda p: dispersion_energy_pairs(sys_, compute_virtual_sites(sys_, p), mp, mp_mask,
                                              cutoff=cfg.cutoff,
                                              switch_width=cfg.dispersion_switch_width), pos))
    else:
        disp = ('dispersion fwd+bwd (dense)', _fwd_bwd(
            lambda p: dispersion_energy(sys_, compute_virtual_sites(sys_, p), cutoff=cfg.cutoff,
                                        switch_width=cfg.dispersion_switch_width), pos))
    table = {
        'evaluation (ASPC, prebuilt lists)': lambda: pot._energy_forces_impl(pos, mu0, (pl, tl)),
        'PME electrostatics (ASPC)': no_grad(
            lambda: pme_mod.pme_electrostatics(params, pot.pme, pos_v, mu0=mu0,
                                               block=pot._block_info,
                                               tables=pot._site_tables())),
        'DMS charges + dq/dr': no_grad(lambda: elec.assemble_charges(params, pos_v)),
        'three-body fwd+bwd': _fwd_bwd(
            lambda p: three_body_energy(sys_, compute_virtual_sites(sys_, p), tl[0], tl[1],
                                        pip=pip), pos),
        'two-body fwd+bwd': _fwd_bwd(
            lambda p: two_body_energy(sys_, compute_virtual_sites(sys_, p), pl[0], pl[1],
                                      pip=pip), pos),
        'one-body fwd+bwd': _fwd_bwd(
            lambda p: torch.sum(one_body_energy(water_positions(sys_, p))), pos),
        disp[0]: disp[1],
        'neighbor-list build (2B/3B)': lambda: pot.build_neighbor_lists(pos),
    }
    if pot.disp_mode == 'pairs':
        table['dispersion pair-list build'] = disp_list
    if pot.elec_mode == 'block':
        sites, (tiles,) = pme_mod.block_sites(params, pot.pme, pos_v, charges,
                                              pot._block_info)
        n = pos_v.shape[0]
        mu_s = mu0[pot._block_info['perm']].contiguous()
        n_lines = pot._block_info['line_capacity']
        _, lines = BS.fixed_field_and_scf_lines(sites, n, tiles, consts, n_lines)
        mu_pad = BS.pad_rows(mu_s, sites.shape[0])
        table.update({
            'tile-pair list build': lambda: pme_mod.block_sites(params, pot.pme, pos_v, charges,
                                                                pot._block_info),
            'K1-bs wrapper call': lambda: BS.fixed_field_and_scf_lines(sites, n, tiles, consts,
                                                                       n_lines),
            'K3-bs wrapper call': lambda: BS.scf_dipole_field_bs(sites, lines, mu_pad, tiles, n,
                                                                 consts),
            'K2-bs wrapper call': lambda: BS.direct_energy_force_pot_bs(sites, mu_s, n, tiles,
                                                                        consts)})
    else:
        sites = ED.pack_sites(
            pos_v, charges,
            torch.as_tensor(np.asarray(params.damping) ** (-1.0 / 6.0), dtype=pos.dtype,
                            device=dev),
            torch.as_tensor(params.mol_index, device=dev),
            torch.as_tensor(params.atom_type == 0, device=dev))
        table.update({
            'K1 wrapper call': lambda: ED.fixed_field_and_scf_factors(sites, consts),
            'K2 wrapper call': lambda: ED.direct_energy_force_pot(sites, mu0.contiguous(),
                                                                  consts)})
    return {name: median_ms(fn, reps) for name, fn in table.items()}


def profiled_steps(sim, n):
    """Wall seconds of sim.step(n) under torch.profiler, and the device
    kernels' (count, summed device microseconds) by name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.step(n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, _kernels(prof)


def _kernels(prof):
    per_kernel = {}
    for ev in prof.key_averages():
        us = ev.device_time_total
        if us > 0:
            per_kernel[ev.key] = (ev.count, us)
    return per_kernel


def timed_steps(sim, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step(n)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def per_step(sim, n):
    """Per MD step, from the difference of n and 2 n steps (the fixed cost
    of a call, its converged evaluations, cancels): (wall ms without the
    profiler, device kernels and device ms under it, the 2 n run's
    kernels). The profiler's own host cost (and its first graph launches)
    stays out of the wall time."""
    wall = (timed_steps(sim, 2 * n) - timed_steps(sim, n)) / n * 1e3
    _, ker_a = profiled_steps(sim, n)
    _, ker_b = profiled_steps(sim, 2 * n)
    launches = (sum(c for c, _ in ker_b.values()) - sum(c for c, _ in ker_a.values())) / n
    dev_ms = (sum(u for _, u in ker_b.values()) - sum(u for _, u in ker_a.values())) / n / 1e3
    return wall, launches, dev_ms, ker_b


def replay_ms(sim, reps):
    """Device milliseconds of one replay of sim's step graph, from CUDA
    events around reps back-to-back replays (the step's kernels and the
    gaps between them on the card, without the host's per-step work)."""
    graph = sim._graph.graph
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def list_build_ms(pot, pos, reps):
    """Device ms of one 2B/3B list build (the build every captured 'auto'
    step makes before selecting), summed over its kernels by the profiler."""
    from torch.profiler import ProfilerActivity, profile
    pot.build_neighbor_lists(pos)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            pot.build_neighbor_lists(pos)
        torch.cuda.synchronize()
    ker = _kernels(prof)
    return (sum(u for _, u in ker.values()) / reps / 1e3,
            sum(c for c, _ in ker.values()) / reps)


def breakdown(waters, pip_impl, reps, n, card, compact_eval=None):
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.system import (System, compute_virtual_sites,
                                                      make_molecules_whole, replicate)
    dev = torch.device('cuda')
    with np.load(FIXTURE) as z:
        system = System.from_atom_names(z['names'], z['resnames'], box=[BOX] * 3)
        pos = torch.as_tensor(np.array(z['positions']), dtype=torch.float32, device=dev)
    pos = make_molecules_whole(system, pos)
    if waters == 4096:
        system, pos = replicate(system, pos, (2, 2, 4))
    pos = compute_virtual_sites(system, pos)
    pot = MBPol(system, MBPolConfig.for_dynamics(pip_impl=pip_impl, compact_eval=compact_eval))
    if waters == 4096:
        pot.tune_capacities(pos)
    print(f'water{system.n_waters}: electrostatics {pot.elec_mode}, dispersion {pot.disp_mode}, '
          f'pip_impl {pip_impl or "quad"}, compact_eval {compact_eval!r}')

    ms = pieces(pot, pos, reps)
    print(f'pieces of one evaluation, median of {reps} synchronized calls ({card}):')
    for name, v in ms.items():
        print(f'  {name:36s} {v:9.3f} ms')

    steps = {}
    for mode in ('eager', 'captured'):
        sim = Simulation(pot, SimulationConfig(dt=0.0002, nlist_rebuild_interval='auto'),
                         _eager=mode == 'eager')
        assert sim.captured == (mode == 'captured')
        sim.set_positions(pos)
        sim.step(2)                                     # warm-up (and the capture)
        step_ms, launches, dev_ms, ker = per_step(sim, n)
        row = dict(wall_ms=step_ms, kernels=launches, device_ms=dev_ms,
                   busy_share=dev_ms / step_ms if step_ms > 0 else None,
                   top=sorted(ker.items(), key=lambda kv: -kv[1][1])[:10])
        if mode == 'captured':
            row['capture_ms'] = sim.capture_ms[0]
            row['replay_ms'] = replay_ms(sim, 5 * n)
            # torch.profiler either sees the kernels a graph replay runs or not
            row['profiler_sees_graph_kernels'] = launches > 0
        steps[mode] = row
        del sim
    build_dev_ms, build_kernels = list_build_ms(pot, pos, reps)
    e, c = steps['eager'], steps['captured']
    print(f'per MD step (difference of {2 * n} and {n} profiled steps; {card}):')
    for mode, r in steps.items():
        busy = 'n/a' if r['busy_share'] is None else f'{100 * r["busy_share"]:.1f}%'
        print(f'  {mode:8s} wall {r["wall_ms"]:.3f} ms, {r["kernels"]:.1f} device kernels, '
              f'device time {r["device_ms"]:.3f} ms, busy {busy}')
    if not c['profiler_sees_graph_kernels']:
        print('  torch.profiler saw no kernel of the graph replays: their device time is read '
              'from CUDA events below')
    print(f'  captured: one replay {c["replay_ms"]:.3f} ms of device time (CUDA events over '
          f'{5 * n} back-to-back replays); capture {c["capture_ms"]:.1f} ms; speedup '
          f'{e["wall_ms"] / c["wall_ms"]:.2f}x in wall per step')
    print(f'  the per-step 2B/3B list build: {build_dev_ms:.3f} ms of device time in '
          f'{build_kernels:.1f} kernels = {100 * build_dev_ms / c["replay_ms"]:.1f}% of a replay')
    print(f'largest device items over {2 * n} eager steps (count, ms):')
    for key, (cnt, us) in e['top']:
        print(f'  {cnt:7d} {us / 1e3:9.3f}  {key[:90]}')
    for r in steps.values():
        r['top'] = [dict(name=k[:120], count=cnt, ms=us / 1e3) for k, (cnt, us) in r['top']]
    return dict(waters=system.n_waters, elec_mode=pot.elec_mode, disp_mode=pot.disp_mode,
                pip_impl=pip_impl or 'quad', compact_eval=compact_eval, reps=reps, steps=n,
                pieces_ms=ms,
                step=steps, list_build_device_ms=build_dev_ms,
                list_build_kernels=build_kernels,
                # the earlier keys, of the captured step
                step_wall_ms=c['wall_ms'], kernels_per_step=c['kernels'],
                device_ms_per_step=c['device_ms'], busy_share=c['busy_share'])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--waters', type=int, nargs='+', choices=(256, 4096), default=[256])
    ap.add_argument('--pip-impl', default=None,
                    help="MBPolConfig.pip_impl: 'quad' (default), 'monomial', 'pallas', "
                         "'quad_pallas', 'quad_bf16' or 'vech_pallas'")
    ap.add_argument('--compact-eval', default='none', choices=('none', 'true', 'rebuild'),
                    help='MBPolConfig.compact_eval: none (default), true or rebuild')
    ap.add_argument('--reps', type=int, default=10)
    ap.add_argument('--steps', type=int, default=20)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('step_breakdown needs a CUDA card')
    card = card_line()
    compact = {'none': None, 'true': True, 'rebuild': 'rebuild'}[args.compact_eval]
    rows = [breakdown(w, args.pip_impl, args.reps, args.steps, card, compact)
            for w in args.waters]
    result = dict(card=card, runs=rows)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    print(line)


if __name__ == '__main__':
    main()
