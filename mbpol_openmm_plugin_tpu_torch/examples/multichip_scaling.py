"""Multi-device scaling harness (examples/multichip_scaling.py on the port):
the water256 fixture replicated to water{512..16384}, every padded capacity
sized by parallel/plan.py from the replicated positions (exact counts), the
potential split over a parallel.mesh.Mesh of n_devices shards
(MBPol(mesh=, plan=)), one converged evaluation, then a short velocity
Verlet run with the lists built once at the start and each step's SCF
started from the last step's dipoles, run twice from the same start (a
warm-up, then timed, synchronized).

With as many cards visible as n_devices the shards sit on distinct cards
(not verified on a card: the machines this was run on have one); otherwise
the mesh repeats the one device (shards of cuda:0, or of the CPU with
--device cpu), which checks the split and the gathers, not transfers
between cards.

    python -m mbpol_openmm_plugin_tpu_torch.examples.multichip_scaling 2048 4
    SCALING_STEPS=3 python -m mbpol_openmm_plugin_tpu_torch.examples.multichip_scaling \
        512 2 --device cpu
"""
from __future__ import annotations

import argparse
import os
import time

from mbpol_openmm_plugin_tpu_torch.examples import _common
from mbpol_openmm_plugin_tpu_torch.utils import cli

DT = 2e-4
# the fixture cell's total energy, kcal/mol (the script's reference line)
CELL_KCAL = -2261.7


def planned_potential(pos_np, box, n_devices, device='cuda', cfg=None):
    """(system, plan, mesh, MBPol(mesh=, plan=), positions) of the waters at
    pos_np (numpy [4 n, 3]) in box."""
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol
    from mbpol_openmm_plugin_tpu_torch.parallel.plan import plan_capacities
    from mbpol_openmm_plugin_tpu_torch.system import System, compute_virtual_sites
    sys_ = System.waters(len(pos_np) // 4, box=box)
    cfg = cfg or _common.config()
    dev = cli.device(device)
    plan = plan_capacities(sys_.n_waters, box, n_devices=n_devices, config=cfg,
                           positions=pos_np, device=dev)
    mesh = _common.example_mesh(n_devices, dev)
    pot = MBPol(sys_, cfg, mesh=mesh, plan=plan)
    pos = compute_virtual_sites(sys_, pot.as_positions(pos_np))
    return sys_, plan, mesh, pot, pos


def verlet(pot, pos, f, mu, nl, n_steps):
    """n_steps of the script's velocity Verlet from rest at pos with forces
    f: (positions, energies [n_steps]) after them."""
    import torch

    from mbpol_openmm_plugin_tpu_torch.md import integrators as I
    inv_m = I.inv_masses(pot.system, pos)
    p, v = pos, torch.zeros_like(pos)
    es = []
    for _ in range(n_steps):
        v_half = v + 0.5 * DT * f * inv_m
        p = p + DT * v_half
        e, f, _, d = pot._energy_forces_impl(p, mu, nlists=nl)
        v = v_half + 0.5 * DT * f * inv_m
        mu = d['induced_dipoles']
        es.append(e)
    return p, torch.stack(es)


def run(n_waters=2048, n_devices=None, n_steps=None, device='cuda', echo=True):
    """The script's run; returns the plan, the single point, its overflow
    flags and convergence, and the MD loop's ms/step."""
    import torch
    say = print if echo else (lambda *a, **k: None)
    dev = cli.device(device)
    if n_devices is None:
        n_devices = min(torch.cuda.device_count(), 8) if dev.type == 'cuda' else 1
    n_steps = int(os.environ.get('SCALING_STEPS', 3)) if n_steps is None else n_steps
    sys_, plan, mesh, pot, pos = planned_potential(*_common.replicated(n_waters), n_devices, dev)
    say(plan.describe())
    say(f'mesh: {mesh.size} shard(s) on {[str(d) for d in mesh.distinct()]}')
    t0 = time.perf_counter()
    e, f, parts, diag = pot.energy_forces(pos)
    _common.sync(dev)
    first = time.perf_counter() - t0
    e_kcal = float(e) / 4.184
    say(f'first evaluation {first:.1f} s')
    say(f'E = {e_kcal:.2f} kcal/mol ({e_kcal / (n_waters / 256):.2f} per water256 cell; fixture '
        f'cell total {CELL_KCAL})')
    bad = {k: bool(v) for k, v in diag.items() if k.endswith('_overflow') and bool(v)}
    if bad:
        raise RuntimeError(f'capacity plan overflowed: {bad}')
    if not bool(diag['converged']):
        raise RuntimeError('the single point did not converge')
    # short MD: warm throughput with prebuilt lists + warm dipoles
    mu = diag['induced_dipoles']
    nl, _ = pot.build_neighbor_lists(pos)
    t0 = time.perf_counter()
    verlet(pot, pos, f, mu, nl, n_steps)
    _common.sync(dev)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, es = verlet(pot, pos, f, mu, nl, n_steps)
    _common.sync(dev)
    ms = (time.perf_counter() - t0) / n_steps * 1e3
    finite = bool(torch.isfinite(es).all())
    say(f'MD loop: {ms:.1f} ms/step over {mesh.size} shard(s) (first pass {t_first:.1f} s); '
        f'energies finite: {finite}')
    return dict(plan=plan, mesh_shards=mesh.size, mesh_devices=[str(d) for d in mesh.distinct()],
                energy=float(e), forces=cli.to_numpy(f), first_eval_s=first,
                converged=bool(diag['converged']), overflow=bad, md_ms_per_step=ms,
                md_energies=cli.to_numpy(es), md_finite=finite)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('n_waters', nargs='?', type=int, default=2048)
    ap.add_argument('n_devices', nargs='?', type=int, default=None)
    cli.add_device_argument(ap)
    a = ap.parse_args(argv)
    run(a.n_waters, a.n_devices, device=a.device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
