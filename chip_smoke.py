#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (mbpol_openmm_plugin_tpu_torch).

Drives the port's main path on one CUDA card: MB-pol water256 bulk PME in
float32, first as a single-point evaluation against the reference golden
total, then as 200 velocity-Verlet NVE steps under
MBPolConfig.for_dynamics() (the ASPC dipole closure). Before that it builds
the hand-written CUDA kernels from csrc/ and holds each against its plain
PyTorch twin at the shapes the main path gives it.

Phases (any failure raises and the script exits non-zero):
  1. card identity (nvidia-smi name and power limit), TF32 off;
  2. kernel build (nvcc, timed, with the compiler's resource report);
  3. each kernel against its twin on the water256 fixture, on the entry
     sets and bounds of ops/elec_direct_check.py; the kernel's device
     time (torch.profiler) and the twin's time per call;
  4. single point vs the golden -2270.8889 +/- 20 kcal/mol;
  5. 200 MD steps: finite energies, no list overflow, healthy SCF,
     |E_tot(end) - E_tot(start)| <= 12 kJ/mol, and every kernel launched
     at least once per step.
The last two lines are a JSON summary of the kernels and
{"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py     (needs one CUDA card; no arguments)
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, 'tests', 'fixtures', 'water256_integration_test.npz')
BOX = 19.3996888399961804 / 10.0
GOLDEN_KCAL = -2270.88890
GOLDEN_TOL_KCAL = 20.0
MD_STEPS = 200
MD_DRIFT_TOL_KJ = 12.0
N_TIMING = 20
SOURCE = 'mbpol_openmm_plugin_tpu_torch/csrc/elec_direct.cu'
# the TPU kernel each replaces: _fixed_field_kernel_tri, _pair_force_kernel_tri
REPLACES = {
    'fixed_field_and_scf_factors': 'mbpol_openmm_plugin_tpu/ops/elec_pallas.py:315',
    'direct_energy_force_pot': 'mbpol_openmm_plugin_tpu/ops/elec_pallas.py:364',
}
# The kernel/twin bounds are in mbpol_openmm_plugin_tpu_torch/ops/elec_direct_check.py.


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn):
    """Median of N_TIMING calls, each between two CUDA events and followed
    by a synchronize: the wrapper call, host work included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(N_TIMING):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def loop_ms(torch, fn):
    """Mean time per call of N_TIMING back-to-back calls between two CUDA
    events (one synchronize at the end): device time once the device,
    not the host, is the slower of the two."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(N_TIMING):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / N_TIMING


def kernel_device_ms(torch, fn, kernel):
    """Mean device time of one launch of the CUDA kernel named `kernel`
    over N_TIMING calls of fn, read from torch.profiler's device trace.
    None when the trace holds no device time for it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(N_TIMING):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total_us += ev.device_time_total
            count += ev.count
    return total_us / count / 1e3 if count and total_us > 0 else None


def load_water256(torch, device, dtype):
    from mbpol_openmm_plugin_tpu_torch.system import (System, compute_virtual_sites,
                                                      make_molecules_whole)
    with np.load(FIXTURE) as z:
        names, resnames, positions = z['names'], z['resnames'], z['positions']
    system = System.from_atom_names(names, resnames, box=[BOX] * 3)
    pos = torch.as_tensor(np.array(positions), dtype=dtype, device=device)
    pos = compute_virtual_sites(system, make_molecules_whole(system, pos))
    return system, pos


def phase_kernels(torch, card, record):
    """Phase 3: each kernel against its twin on the water256 fixture."""
    from mbpol_openmm_plugin_tpu_torch.models import electrostatics as elec
    from mbpol_openmm_plugin_tpu_torch.models.pme import PmeSetup
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_check as check

    dev = torch.device('cuda')
    system, pos = load_water256(torch, dev, torch.float32)
    params = elec.ElecParams.for_system(system)
    setup = PmeSetup.from_config(system, MBPolConfig(nonbonded_method='PME', cutoff=0.9))
    consts = ED.DirectConsts.from_setup(setup, params.thole)
    charges, _ = elec.assemble_charges(params, pos)
    d16 = torch.as_tensor(np.asarray(params.damping) ** (-1.0 / 6.0), dtype=pos.dtype,
                          device=dev)
    sites = ED.pack_sites(pos, charges, d16, torch.as_tensor(params.mol_index, device=dev),
                          torch.as_tensor(params.atom_type == 0, device=dev))
    polarity = torch.as_tensor(params.polarity, dtype=pos.dtype, device=dev)
    log(f'sites {tuple(sites.shape)} {sites.dtype}, cutoff {consts.cutoff} nm, '
        f'alpha {consts.alpha:.6f} 1/nm')

    k1 = ED.fixed_field_and_scf_factors(sites, consts)
    torch.cuda.synchronize()
    t1 = ED.fixed_field_and_scf_factors_plain(sites, consts)
    torch.cuda.synchronize()
    t1_64 = ED.fixed_field_and_scf_factors_plain(sites.double(), consts)
    # induced dipoles of realistic size: polarity times the direct field
    mu = (polarity[:, None] * t1[0]).contiguous()
    k2 = ED.direct_energy_force_pot(sites, mu, consts)
    torch.cuda.synchronize()
    t2 = ED.direct_energy_force_pot_plain(sites, mu, consts)
    torch.cuda.synchronize()

    failures = []
    for kname, rows, kout, tout in (
            ('fixed_field_and_scf_factors', check.k1_rows(sites, polarity, k1, t1, t1_64), k1, t1),
            ('direct_energy_force_pot', check.k2_rows(k2, t2), k2, t2)):
        for row in rows:
            log(f'  {kname:28s} {row}')
            if not row.ok:
                failures.append(f'{kname}.{row.output}.{row.entries}.{row.measure}')
        max_abs = max(float((k - t).abs().max()) for k, t in zip(kout, tout))
        record[kname] = dict(name=kname, route='cuda', source=SOURCE,
                             replaces=REPLACES[kname], max_abs_err=max_abs)

    timed = (('fixed_field_and_scf_factors', 'fixed_field_kernel',
              lambda: ED.fixed_field_and_scf_factors(sites, consts),
              lambda: ED.fixed_field_and_scf_factors_plain(sites, consts)),
             ('direct_energy_force_pot', 'direct_efp_kernel',
              lambda: ED.direct_energy_force_pot(sites, mu, consts),
              lambda: ED.direct_energy_force_pot_plain(sites, mu, consts)))
    for kname, cuda_name, kern, plain in timed:
        dev_ms, kern_loop = kernel_device_ms(torch, kern, cuda_name), loop_ms(torch, kern)
        plain_loop = loop_ms(torch, plain)
        call_ms, plain_call = median_ms(torch, kern), median_ms(torch, plain)
        ms = dev_ms if dev_ms is not None else kern_loop
        record[kname].update(ms=ms, plain_ms=plain_loop)
        log(f'  {kname:28s} N={sites.shape[0]}: kernel device time '
            f'{"not in the profiler trace" if dev_ms is None else f"{dev_ms:.4f} ms"}; '
            f'back-to-back per call: kernel {kern_loop:.4f} ms, twin {plain_loop:.4f} ms; '
            f'synchronized wrapper call (median): kernel {call_ms:.4f} ms, twin '
            f'{plain_call:.4f} ms ({N_TIMING} calls each; {card})')
    if failures:
        raise AssertionError(f'kernel/twin mismatch: {failures}')


def phase_single_point(torch, card):
    """Phase 4: water256 PME f32 single point against the golden total."""
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
    from mbpol_openmm_plugin_tpu_torch.utils import units

    system, pos = load_water256(torch, torch.device('cuda'), torch.float32)
    pot = MBPol(system, MBPolConfig(nonbonded_method='PME', cutoff=0.9, target_epsilon=1e-4,
                                    nlist_skin=0.02, max_iterations=200))
    ED.reset_launch_counts()
    t0 = time.perf_counter()
    e, f, parts, diag = pot.energy_forces(pos)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    e_kcal = float(e) * units.KJ_PER_MOL_TO_KCAL_PER_MOL
    log('  per-term (kcal/mol): ' + ', '.join(
        f'{k} {float(v) * units.KJ_PER_MOL_TO_KCAL_PER_MOL:.4f}' for k, v in parts.items()))
    log(f'  total {e_kcal:.4f} kcal/mol, golden {GOLDEN_KCAL} +/- {GOLDEN_TOL_KCAL}; '
        f'SCF iterations {int(diag["iterations"])}, converged {bool(diag["converged"])}; '
        f'wall {wall * 1e3:.1f} ms ({card})')
    launches = {k.__name__: k.launches for k in ED.KERNELS}
    log(f'  kernel launches: {launches}')
    assert bool(diag['converged']), 'SCF did not converge'
    assert bool(torch.isfinite(f).all()), 'non-finite forces'
    assert not bool(diag['pair_overflow']) and not bool(diag['triplet_overflow'])
    assert abs(e_kcal - GOLDEN_KCAL) <= GOLDEN_TOL_KCAL, e_kcal
    assert all(n > 0 for n in launches.values()), launches


def phase_md(torch, card, record):
    """Phase 5: 200 NVE steps under MBPolConfig.for_dynamics()."""
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED

    system, pos = load_water256(torch, torch.device('cuda'), torch.float32)
    pot = MBPol(system, MBPolConfig.for_dynamics())
    sim = Simulation(pot, SimulationConfig(dt=0.0002, nlist_rebuild_interval='auto'))
    ED.reset_launch_counts()
    sim.set_positions(pos)
    e_start = float(sim.state.potential_energy)    # velocities start at zero
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sim.step(MD_STEPS)      # raises on NaN, list overflow or a failed SCF
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in ED.KERNELS}
    t1 = time.perf_counter()
    pot.energy_forces(sim.state.positions)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t1) * 1e3
    e_end = float(out['total_energy'][-1])
    drift = abs(e_end - e_start)
    log(f'  E_tot start {e_start:.4f} kJ/mol, end {e_end:.4f} kJ/mol, '
        f'|dE| {drift:.4f} kJ/mol (bound {MD_DRIFT_TOL_KJ}); T_end {out["temperature"][-1]:.2f} K')
    log(f'  {MD_STEPS} steps in {wall:.3f} s = {MD_STEPS / wall:.2f} steps/s, including the two '
        f'converged evaluations step() makes at the chunk start and end (one takes '
        f'{cold_ms:.1f} ms) ({card})')
    log(f'  kernel launches during the MD run: {launches}')
    assert np.all(np.isfinite(out['total_energy'])), out
    assert drift <= MD_DRIFT_TOL_KJ, drift
    assert all(n >= MD_STEPS for n in launches.values()), launches
    for name, n in launches.items():
        record[name]['launches'] = n
    return MD_STEPS / wall


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device visible (torch.cuda.is_available() is false)',
              file=sys.stderr)
        return 2
    import mbpol_openmm_plugin_tpu_torch  # noqa: F401  (precision switches)
    from mbpol_openmm_plugin_tpu_torch.ops import _build

    log('== phase 1: card')
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f'  {card}')
    log(f'  torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, '
        f'count {torch.cuda.device_count()}')
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == 'highest'

    log('== phase 2: kernel build')
    t0 = time.perf_counter()
    path = _build.build()
    log(f'  built {os.path.relpath(path, REPO)} in {time.perf_counter() - t0:.2f} s')
    for line in _build.build_log().splitlines():
        if 'registers' in line or 'spill' in line or 'Compiling' in line:
            log('  ' + line.strip())

    record = {}
    log('== phase 3: kernels vs twins (water256, float32)')
    phase_kernels(torch, card, record)
    log('== phase 4: single point (water256 PME, float32)')
    phase_single_point(torch, card)
    log('== phase 5: MD (water256, for_dynamics, 200 Verlet steps at 0.2 fs)')
    phase_md(torch, card, record)

    log(card)
    log(json.dumps({'kernels': [record[k] for k in REPLACES]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
