"""Bulk scaling run: the water256 box replicated 2 x 2 x 2 (water2048) or
2 x 2 x 4 (water4096, pass 4096), the full PME potential on the card
(examples/water2048_scaling.py on the port), under each electrostatics mode:
'dense' (the direct-space kernels over all site pairs, O(N^2) memory),
'block' (the block-sparse kernels over the tile pairs in the cutoff, O(N)
memory) and 'sparse' (the water-pair list path).

Per mode: the capacities after tune_capacities, one converged single point
(SCF eps 1e-3; its first-call wall), the SCF diagnostics and overflow
flags, and the warm evaluation (prebuilt lists, the converged dipoles as
the start) timed over 20 calls (synchronized).

    python -m mbpol_openmm_plugin_tpu_torch.examples.water2048_scaling [n_waters] [modes]

modes is a comma list (default 'block,dense' up to 2048 waters, 'block'
above).
"""
from __future__ import annotations

import argparse
import time

from mbpol_openmm_plugin_tpu_torch.examples import _common
from mbpol_openmm_plugin_tpu_torch.utils import cli

N_WARM = 20
# the fixture cell's total energy, kcal/mol (the script's reference line)
CELL_KCAL = -2261.7


def default_modes(n_waters):
    return ['block', 'dense'] if n_waters <= 2048 else ['block']


def system_and_positions(n_waters):
    """(System, positions numpy, box) of the fixture replicated to n_waters."""
    from mbpol_openmm_plugin_tpu_torch.system import System
    pos, box = _common.replicated(n_waters)
    return System.waters(n_waters, box=box), pos, box


def mode_run(sys_, pos_np, mode, device='cuda', n_warm=N_WARM, config=None, echo=True):
    """One mode's readings (see the module docstring); config overrides the
    MBPolConfig fields (the script's: PME, 0.9 nm, eps 1e-3, skin 0.02)."""
    import torch

    say = print if echo else (lambda *a, **k: None)
    _, pot, pos, _ = _common.water_potential(device, positions=pos_np, box=sys_.box,
                                             mbpol_config=_common.config(
                                                 electrostatics_mode=mode, **(config or {})))
    dev = pot.device
    out = dict(mode=pot.elec_mode, disp_mode=pot.disp_mode, pair_cap=pot.pair_cap,
               trip_cap=pot.trip_cap)
    extra = ''
    if pot.elec_mode == 'block':
        out['tile_pair_capacity'] = int(pot._block_info['tile_pair_capacity'])
        extra = ', tile pairs cap %d' % out['tile_pair_capacity']
    say(f'[{mode}] pair capacity {pot.pair_cap}, triplet capacity {pot.trip_cap}{extra}, '
        f'dispersion {pot.disp_mode}')
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    e, f, parts, diag = pot.energy_forces(pos)
    _common.sync(dev)
    out['first_eval_s'] = time.perf_counter() - t0
    out.update(energy=float(e), forces=cli.to_numpy(f),
               parts={k: float(v) for k, v in parts.items()},
               iterations=int(diag['iterations']), converged=bool(diag['converged']),
               overflow={k: bool(v) for k, v in diag.items() if 'overflow' in k})
    say('[%s] first evaluation %.1f s' % (mode, out['first_eval_s']))
    say('[%s] E = %.2f kcal/mol  (%d x water256 = %.2f)'
        % (mode, out['energy'] / 4.184, sys_.n_waters // 256, sys_.n_waters / 256 * CELL_KCAL))
    say('[%s] SCF iterations: %d converged: %s' % (mode, out['iterations'], out['converged']))
    if any(out['overflow'].values()):
        say('[%s] WARNING: overflow flags set: %s' % (mode, out['overflow']))
    # warm evaluation throughput (prebuilt lists, warm dipoles)
    mu = diag['induced_dipoles']
    nl, _ = pot.build_neighbor_lists(pos)
    pot._energy_forces_impl(pos, mu, nlists=nl)
    _common.sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_warm):
        pot._energy_forces_impl(pos, mu, nlists=nl)
    _common.sync(dev)
    out['warm_eval_ms'] = (time.perf_counter() - t0) / n_warm * 1e3
    if dev.type == 'cuda':
        out['peak_gib'] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    say('[%s] warm evaluation: %.1f ms' % (mode, out['warm_eval_ms']))
    return out


def run(n_waters=2048, modes=None, device='cuda', n_warm=N_WARM, echo=True):
    """{mode: readings} over the modes."""
    sys_, pos, _ = system_and_positions(n_waters)
    return {m: mode_run(sys_, pos, m, device, n_warm, echo=echo)
            for m in (modes or default_modes(n_waters))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('n_waters', nargs='?', type=int, default=2048)
    ap.add_argument('modes', nargs='?', default=None, help="comma list, e.g. 'dense,block,sparse'")
    cli.add_device_argument(ap)
    a = ap.parse_args(argv)
    run(a.n_waters, a.modes.split(',') if a.modes else None, a.device)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
