"""Long-horizon NVE energy drift of the water256 fixture (the port's
counterpart of tools/nve_drift.py).

Velocity Verlet under MBPolConfig.for_dynamics() (the ASPC closure with a
Kolafa predictor of order --aspc-k, displacement-triggered lists), from
Maxwell-Boltzmann velocities, thermalized at the target temperature by
reassigning them every --seg steps for --therm steps, then one settling
segment and the measured window of --steps steps. The drift is the linear
fit of the total energy over the segment boundaries, in kJ/mol/ns and
K/ns (Delta E / ((3 N / 2) k_B)). --kahan keeps the positions and
velocities as compensated float32 pairs (utils/compensated.py), which
recovers the low bits the float32 update p += dt v rounds away.

Each MD step is one replay of one CUDA graph on the card (the body
`DriftRun.body` on the buffers of md/step_graph.StepGraph); elsewhere it
runs as it stands. The step reads nothing on the host: the list trigger
selects on the device between the lists built at the step's positions and
the carried ones.

    python -m mbpol_openmm_plugin_tpu_torch.tools.nve_drift --steps 50000 [--kahan]

prints one JSON line per arm (--arms plain kahan runs both in turn).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch.md import integrators as I
from mbpol_openmm_plugin_tpu_torch.md.step_graph import StepGraph
from mbpol_openmm_plugin_tpu_torch.models import electrostatics as elec
from mbpol_openmm_plugin_tpu_torch.system import oxygen_positions
from mbpol_openmm_plugin_tpu_torch.utils import cli, units
from mbpol_openmm_plugin_tpu_torch.utils.compensated import comp_add
from mbpol_openmm_plugin_tpu_torch.utils.consts import device_const

# capacity margin of the long runs: a 10 ps window samples deeper density
# fluctuations than a short run
MARGIN = 1.6


class DriftRun:
    """NVE steps of `pot` (an ASPC potential with nlist_skin > 0) from
    positions and velocities: the state, the compensation terms (zero
    without kahan), the ASPC dipole history and the carried lists live in
    the buffers of one StepGraph, replayed once per step on a card."""

    def __init__(self, pot, positions, velocities, dt_ps, kahan):
        if pot.config.scf_method != 'aspc' or not pot.config.nlist_skin > 0:
            raise ValueError('the drift run takes an ASPC potential with nlist_skin > 0')
        self.pot, self.system, self.dt, self.kahan = pot, pot.system, float(dt_ps), bool(kahan)
        pos = pot.as_positions(positions)
        e, f, _, diag = pot.energy_forces(pos)
        B = device_const(elec.aspc_predictor_coefficients(pot.config.aspc_k), dtype=pos.dtype,
                         device=pos.device)
        (pl, tl), d = pot.build_neighbor_lists(pos)
        src = dict(positions=pos, velocities=pot.as_positions(velocities), forces=f, pe=e,
                   pc=torch.zeros_like(pos), vc=torch.zeros_like(pos),
                   mu=diag['induced_dipoles'][None].repeat(len(B), 1, 1),
                   pairs=pl[0], pmask=pl[1], trips=tl[0], tmask=tl[1], nl_pos=pos,
                   ovf=d['pair_overflow'] | d['triplet_overflow'])
        self.graph = StepGraph(pot, None, B, src, pos.device.type == 'cuda')
        self.graph.load(src)

    def body(self, g):
        """One velocity-Verlet step on g's buffers (the JAX tool's scan
        body): the half kick and drift (compensated with kahan), the list
        select, the ASPC evaluation and the second half kick."""
        b, pot, dt = g.buffers, self.pot, self.dt
        inv_m = I.inv_masses(self.system, b['positions'])
        v, vc, p, pc = b['velocities'], b['vc'], b['positions'], b['pc']
        dv1 = 0.5 * dt * b['forces'] * inv_m
        if self.kahan:
            v_half, vc = comp_add(v, vc, dv1)
            p, pc = comp_add(p, pc, dt * v_half)
        else:
            v_half = v + dv1
            p = p + dt * v_half
        disp = torch.max(torch.linalg.norm(oxygen_positions(self.system, p)
                                           - oxygen_positions(self.system, b['nl_pos']), dim=-1))
        fire = (2.0 * disp).to(torch.float64) > 0.5 * pot.config.nlist_skin
        (pl, tl), d = pot.build_neighbor_lists(p)
        old = (b['pairs'], b['pmask'], b['trips'], b['tmask'])
        lists = [torch.where(fire, new, o) for new, o in zip((*pl, *tl), old)]
        mu0 = torch.einsum('h,hnd->nd', g.B, b['mu'])
        e, f, _, diag = pot._energy_forces_impl(p, mu0, nlists=(tuple(lists[:2]),
                                                                tuple(lists[2:])))
        dv2 = 0.5 * dt * f * inv_m
        if self.kahan:
            v, vc = comp_add(v_half, vc, dv2)
        else:
            v = v_half + dv2
        ovf = b['ovf'] | (fire & (d['pair_overflow'] | d['triplet_overflow']))
        for k, val in diag.items():
            if k.endswith('_overflow'):
                ovf = ovf | val
        for k, val in zip(('positions', 'velocities', 'forces', 'pe', 'pc', 'vc', 'ovf', 'nl_pos',
                           'pairs', 'pmask', 'trips', 'tmask'),
                          (p, v, f, e, pc, vc, ovf, torch.where(fire, p, b['nl_pos']), *lists)):
            b[k].copy_(val)
        b['mu'].copy_(torch.cat([diag['induced_dipoles'][None], b['mu'][:-1]]))

    def steps(self, n):
        """n steps; returns the potential energy after the last one (a 0-d
        tensor on the device)."""
        for _ in range(n):
            self.graph.step(self.body)
        return self.graph.buffers['pe'].clone()

    def set_velocities(self, v):
        """New velocities (a resampling) with fresh compensation terms."""
        b = self.graph.buffers
        b['velocities'].copy_(v)
        b['vc'].zero_()
        b['pc'].zero_()

    def kinetic_energy(self):
        return float(I.kinetic_energy(self.system, self.graph.buffers['velocities']))

    def overflow(self):
        return bool(self.graph.buffers['ovf'])


def water256(dt_fs, aspc_k, kahan, skin=0.02, seed=0, temperature=300.0, device='cuda'):
    """(DriftRun of the water256 fixture under for_dynamics(aspc_k, skin)
    after tune_capacities(margin=MARGIN), MB velocities at temperature,
    and the generator that drew them)."""
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.system import System, compute_virtual_sites
    dev = cli.device(device)
    z = cli.load_fixture('water256_integration_test')
    system = System.from_atom_names(z['names'], z['resnames'], box=[cli.BOX256] * 3)
    positions = z['positions']
    pot = MBPol(system, MBPolConfig.for_dynamics(aspc_k=aspc_k, nlist_skin=skin), device=dev)
    pos = compute_virtual_sites(system, pot.as_positions(positions))
    pot.tune_capacities(pos, margin=MARGIN)
    gen = torch.Generator(device=dev).manual_seed(seed)
    v0 = I.maxwell_boltzmann_velocities(system, temperature, _normals(pos, gen))
    return DriftRun(pot, pos, v0, dt_fs * 1e-3, kahan), gen


def _normals(like, gen):
    return torch.randn(like.shape, generator=gen, dtype=like.dtype, device=like.device)


def run(dt_fs=0.2, aspc_k=3, kahan=False, steps=50000, therm=2000, seg=1000, seed=0,
        temperature=300.0, skin=0.02, device='cuda', echo=True):
    """One arm: thermalize (velocities reassigned every seg steps for therm
    steps), settle one segment, then the window of `steps` steps read at
    every seg. Returns the result dict (printed as one JSON line with
    echo)."""
    md, gen = water256(dt_fs, aspc_k, kahan, skin, seed, temperature, device)
    system = md.system
    ndof = 3 * int((np.asarray(system.masses) > 0).sum())
    like = md.graph.buffers['velocities']
    done = 0
    while done < therm:
        md.set_velocities(I.maxwell_boltzmann_velocities(system, temperature,
                                                         _normals(like, gen)))
        n = min(seg, therm - done)
        md.steps(n)
        done += n
    md.steps(seg)
    t_now = 2.0 * md.kinetic_energy() / (ndof * units.BOLTZMANN_KJ_MOL_K)
    ts, es = [], []
    t0 = time.perf_counter()
    done = 0
    while done < steps:
        n = min(seg, steps - done)
        pe = float(md.steps(n))
        done += n
        ts.append(done * dt_fs * 1e-3)
        es.append(pe + md.kinetic_energy())
    wall = time.perf_counter() - t0
    ts, es = np.asarray(ts), np.asarray(es)
    slope = float(np.polyfit(ts, es, 1)[0]) if len(ts) > 2 else \
        float((es[-1] - es[0]) / (ts[-1] - ts[0]))          # kJ/mol/ps
    out = dict(variant=dict(dt_fs=dt_fs, aspc_k=aspc_k, kahan=bool(kahan), skin=skin,
                            steps=steps, therm=therm, seg=seg, seed=seed),
               temperature_K=t_now, window_ps=float(ts[-1] - ts[0]),
               steps_per_second=steps / wall,
               drift_kJmol_per_ns=slope * 1e3,
               drift_K_per_ns=slope * 1e3 / (0.5 * ndof * units.BOLTZMANN_KJ_MOL_K),
               endpoint_drift_kJmol=float(es[-1] - es[0]), series=[float(e) for e in es],
               nan=bool(np.isnan(es).any()), neighbor_overflow=md.overflow())
    if echo:
        print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--steps', type=int, default=50000)
    ap.add_argument('--therm', type=int, default=2000)
    ap.add_argument('--seg', type=int, default=1000)
    ap.add_argument('--dt-fs', type=float, default=0.2)
    ap.add_argument('--aspc-k', type=int, default=3)
    ap.add_argument('--kahan', action='store_true')
    ap.add_argument('--arms', nargs='+', choices=('plain', 'kahan'),
                    help='run these arms in turn (overrides --kahan)')
    ap.add_argument('--skin', type=float, default=0.02)
    ap.add_argument('--seed', type=int, default=0)
    cli.add_device_argument(ap)
    a = ap.parse_args(argv)
    for arm in a.arms or (['kahan'] if a.kahan else ['plain']):
        run(a.dt_fs, a.aspc_k, arm == 'kahan', a.steps, a.therm, a.seg, a.seed, skin=a.skin,
            device=a.device)


if __name__ == '__main__':
    main()
