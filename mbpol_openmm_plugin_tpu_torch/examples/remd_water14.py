"""Parallel tempering (temperature REMD) on the water14 cluster
(examples/remd_water14.py on the port).

A geometric ladder of R replicas over 250-450 K (BAOAB Langevin 2/ps, dt
0.2 fs, an exchange sweep every 25 steps; md/remd.py: the replicas'
evaluations run one after another, eagerly), two blocks of warm-up, then
n_blocks timed blocks (at least 2: MBAR drops the first quarter, at least
one); per-slot <U>, acceptance and the replica flow, then MBAR
(analysis.mbar_*): every slot's samples pooled and reweighted to a
grid of temperatures over the ladder's range. --mesh puts the ladder's
slots over the shards of a parallel.mesh.Mesh of min(R, 4) shards (distinct
cards when that many are visible, else shards of the one card), each shard
through its own copy of the potential.

    python -m mbpol_openmm_plugin_tpu_torch.examples.remd_water14 [n_blocks] [--replicas R] \
        [--mesh]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from mbpol_openmm_plugin_tpu_torch.examples import _common
from mbpol_openmm_plugin_tpu_torch.utils import cli


def simulation(n_replicas, device='cuda', use_mesh=False):
    """(REMDSimulation of the water14 cluster from the example PDB through
    the app layer's ForceField, NoCutoff, at its start; temperatures; the
    mesh or None)."""
    from mbpol_openmm_plugin_tpu_torch import app
    from mbpol_openmm_plugin_tpu_torch.app import unit
    from mbpol_openmm_plugin_tpu_torch.md import remd
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.system import compute_virtual_sites
    dev = cli.device(device)
    pdb = app.PDBFile(_common.pdb_path('water14_cluster'))
    ff = app.ForceField(app.mbpol_xml_path())
    spec = ff.createSystem(pdb.topology, nonbondedMethod=app.NoCutoff)
    # --mesh shards the REPLICA axis (the potential itself stays unmeshed:
    # one sharding level; see REMDSimulation)
    mesh = _common.example_mesh(min(n_replicas, 4), dev) if use_mesh else None
    pot = MBPol(spec.system, MBPolConfig(nonbonded_method='NoCutoff', cutoff=1e3), device=dev)
    pos = compute_virtual_sites(spec.system, pot.as_positions(
        pdb.positions.value_in_unit(unit.nanometer)))
    temps = remd.geometric_ladder(250.0, 450.0, n_replicas)
    cfg = remd.REMDConfig(dt=0.0002, exchange_interval=25, friction=2.0)
    sim = remd.REMDSimulation(pot, temperatures=temps, config=cfg, seed=0, mesh=mesh)
    sim.set_positions(pos)
    sim.set_velocities_to_temperature()
    return sim, temps, mesh


def mbar(u_kn, temps, n_grid):
    """(dimensionless free energies f [R], [(T, <U> kJ/mol, n_eff)] on
    n_grid temperatures over the ladder) from u_kn [R, n] in kJ/mol."""
    from mbpol_openmm_plugin_tpu_torch import analysis
    f = analysis.mbar_free_energies(u_kn, temps)
    grid = []
    for t in np.linspace(temps[0], temps[-1], n_grid):
        w = analysis.mbar_reweight(u_kn, temps, float(t), f=f, observable=u_kn)
        grid.append((float(t), float(w['mean']), float(w['n_eff'])))
    return f, grid


def run(n_blocks=100, n_replicas=4, use_mesh=False, device='cuda', warm_blocks=2, echo=True):
    """The script's run (warm_blocks of equilibration, then n_blocks >= 2
    timed); returns the block outputs, rates, acceptance, the replica flow
    and the MBAR readings."""
    say = print if echo else (lambda *a, **k: None)
    R = n_replicas
    sim, temps, mesh = simulation(R, device, use_mesh)
    cfg = sim.config
    say(f'water14 REMD: {R} replicas at {np.round(temps, 1)} K ({cfg.exchange_interval} '
        f'steps/exchange, dt {cfg.dt * 1000:.2f} fs) mesh={None if mesh is None else mesh.size}')
    t0 = time.time()
    if warm_blocks:
        sim.run(warm_blocks)   # short equilibration
    warm_s = time.time() - t0
    say('first blocks: %.1f s' % warm_s)
    t0 = time.time()
    out = sim.run(n_blocks)
    wall = time.time() - t0
    n_steps = n_blocks * cfg.exchange_interval
    rate = n_steps * R / wall
    say('%d blocks (%d MD steps x %d replicas) in %.1f s -> %.1f replica-steps/s'
        % (n_blocks, n_steps, R, wall, rate))
    pe = out['potential_energy'] / 4.184   # kcal/mol
    for r in range(R):
        say('  slot %d  T=%6.1f K  <U> = %9.3f kcal/mol  acceptance(->%d) %s'
            % (r, temps[r], pe[n_blocks // 4:, r].mean(), r + 1,
               '%.2f' % out['acceptance'][r] if r < R - 1 else '   -'))
    # replica flow: how often the coldest slot's occupant changed
    w0 = np.asarray(out['walker'])[:, 0]
    changes = int((np.diff(w0) != 0).sum())
    say('cold-slot occupant changed %d times over %d blocks; walkers seen: %s'
        % (changes, n_blocks, sorted(set(w0.tolist()))))
    burn = max(1, n_blocks // 4)
    u_kn = np.asarray(out['potential_energy'])[burn:].T          # [R, n_samples] kJ/mol
    f, grid = mbar(u_kn, temps, 2 * R - 1)
    say('MBAR dimensionless free energies:', np.round(f, 2))
    for t, u, n_eff in grid:
        say('  <U>(%5.1f K) = %9.3f kcal/mol   (n_eff %5.0f)' % (t, u / 4.184, n_eff))
    return dict(out=out, temperatures=temps, mesh_shards=None if mesh is None else mesh.size,
                warm_s=warm_s, wall_s=wall, replica_steps_per_second=rate,
                cold_slot_changes=changes, u_kn=u_kn, mbar_f=f, mbar_grid=grid)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('n_blocks', nargs='?', type=int, default=100)
    ap.add_argument('--replicas', type=int, default=4)
    ap.add_argument('--mesh', action='store_true')
    cli.add_device_argument(ap)
    a = ap.parse_args(argv)
    run(a.n_blocks, a.replicas, a.mesh, a.device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
