"""Reference reading of the MD conservation gate of chip_smoke.py (phase 5),
through the JAX package, float32, on the CPU.

    JAX_PLATFORMS=cpu python tools/md_gate_reference.py [--chunks 3] [--out FILE]

Protocol (the one the PyTorch port runs through Simulation.step(600,
report_interval=200)): the water256 integration fixture at rest,
MBPolConfig.for_dynamics(), velocity Verlet at 0.2 fs, in chunks of 200
steps. Each chunk starts like the port's Simulation._chunk: a converged
evaluation at the chunk's first positions seeds the ASPC history (k = 3)
and the neighbor lists are built there; within the chunk the lists are
rebuilt when twice the max O displacement exceeds half the skin.

Per chunk it prints E_tot = PE + KE at steps 0, 100 and 200 of the chunk,
the second-half change E_tot(200) - E_tot(100), and the slope of a
least-squares line through E_tot over steps 100..200, times 100 steps
(both kJ/mol). The chunks are the gate's starts: the fixture, and the
fixture after 200 and 400 steps. The last line is a JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FIXTURE = os.path.join(REPO, 'tests', 'fixtures', 'water256_integration_test.npz')
BOX = 19.3996888399961804 / 10.0
CHUNK = 200
DT = 0.0002


def second_half(e_tot):
    """(E(end) - E(mid), fitted slope over [mid, end] times the half's
    length) of one chunk's per-step E_tot (index 0 = chunk start)."""
    n = len(e_tot) - 1
    half = np.asarray(e_tot[n // 2:], np.float64)
    x = np.arange(len(half), dtype=np.float64)
    slope = np.polyfit(x, half, 1)[0]
    return float(half[-1] - half[0]), float(slope * (len(half) - 1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--chunks', type=int, default=3)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from mbpol_openmm_plugin_tpu.models import electrostatics as elec
    from mbpol_openmm_plugin_tpu.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu.system import (System, compute_virtual_sites,
                                                make_molecules_whole)

    with np.load(FIXTURE) as z:
        system = System.from_atom_names(z['names'], z['resnames'], box=[BOX] * 3)
        pos = jnp.asarray(np.array(z['positions']), jnp.float32)
    pos = compute_virtual_sites(system, make_molecules_whole(system, pos))
    pot = MBPol(system, MBPolConfig.for_dynamics())
    ef = jax.jit(pot._energy_forces_impl)
    masses = np.asarray(system.masses)
    inv_m = jnp.asarray(np.where(masses > 0, 1.0 / np.where(masses > 0, masses, 1.0), 0.0),
                        jnp.float32)[:, None]
    m = jnp.asarray(masses, jnp.float32)[:, None]
    B = jnp.asarray(elec.aspc_predictor_coefficients(pot.config.aspc_k), jnp.float32)
    skin = pot.config.nlist_skin
    o = np.asarray(system.o_index)

    e, f, _, _ = ef(pos)
    v = jnp.zeros_like(pos)
    chunks = []
    t0 = time.perf_counter()
    for c in range(args.chunks):
        d = ef(pos)[3]
        hist = jnp.tile(d['induced_dipoles'][None], (len(B), 1, 1))
        nl, _ = pot.build_neighbor_lists(pos)
        p_build = pos
        e_tot = [float(e) + float(0.5 * jnp.sum(m * v * v))]
        for _ in range(CHUNK):
            v_half = v + 0.5 * DT * f * inv_m
            p = pos + DT * v_half
            disp = float(jnp.max(jnp.linalg.norm(p[o] - p_build[o], axis=-1)))
            if 2.0 * disp > 0.5 * skin:
                nl, _ = pot.build_neighbor_lists(p)
                p_build = p
            e, f, _, d = ef(p, jnp.einsum('h,hnd->nd', B, hist), nlists=nl)
            hist = jnp.roll(hist, 1, axis=0).at[0].set(d['induced_dipoles'])
            v = v_half + 0.5 * DT * f * inv_m
            pos = p
            e_tot.append(float(e) + float(0.5 * jnp.sum(m * v * v)))
        d_half, fit = second_half(e_tot)
        row = dict(start_step=c * CHUNK, e0=e_tot[0], e100=e_tot[CHUNK // 2],
                   e200=e_tot[-1], second_half=d_half, second_half_fit=fit,
                   whole_chunk=e_tot[-1] - e_tot[0])
        chunks.append(row)
        print(f'chunk from step {row["start_step"]}: E_tot {row["e0"]:.4f} / {row["e100"]:.4f} '
              f'/ {row["e200"]:.4f} kJ/mol at 0/100/200; second half {d_half:+.4f}, '
              f'fit {fit:+.4f}, whole chunk {row["whole_chunk"]:+.4f} kJ/mol '
              f'({time.perf_counter() - t0:.0f} s)', flush=True)
    result = dict(platform='cpu', dtype='float32', jax=jax.__version__, chunks=chunks)
    line = json.dumps(result)
    if args.out:
        with open(args.out, 'w') as fh:
            fh.write(line + '\n')
    print(line)


if __name__ == '__main__':
    main()
