#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (mbpol_openmm_plugin_tpu_torch).

Drives the port's paths on one CUDA card, in float32, through the entry
points a user calls (MBPol, tune_capacities, energy_forces, Simulation):
MB-pol water256 bulk PME in the dense electrostatics mode, water4096 (the
water256 fixture repeated 2 x 2 x 4, 16,384 sites) in the block-sparse
mode that 'auto' picks above 2560 waters on a card, and water256 again
with the 2B/3B polynomials evaluated by each fused kernel
(MBPolConfig.pip_impl). It builds the hand-written CUDA kernels from csrc/
and holds each against its plain PyTorch twin at the shapes its path gives
it.

Phases (any failure raises and the script exits non-zero):
  1. card identity (nvidia-smi name and power limit), TF32 off;
  2. kernel build (one nvcc per source, in parallel; timed, with the
     compiler's resource report and warnings);
  3. the dense kernels K1/K2 against their twins on the water256 fixture,
     on the entry sets and bounds of ops/elec_direct_check.py; device time
     (torch.profiler) and the twin's time per call;
  4. water256 single point vs the golden -2270.8889 +/- 20 kcal/mol;
  5. water256 MD, 200 steps under for_dynamics(): finite energies, no list
     overflow, healthy SCF, energy conservation after the ASPC start-up
     transient (|fitted change of E_tot over steps 100..200| <= MD_FIT_TOL_KJ,
     see PERF.md), and K1/K2 launched at least once per step;
  6. the block kernels K1-bs/K3-bs/K2-bs against their twins at water4096,
     in the sorted order tune_capacities picks (the padded list holds
     inactive-pair padding), on the entry sets of ops/elec_direct_check.py;
  7. replication: the water4096 single point (PME grid exactly 2 x 2 x 4
     the water256 one, SCF to 1e-4) against phase 4, energy per water
     within 1e-4 relative, every copy's electrostatics + dispersion forces
     within 1e-3 max|F| and its whole forces within REPLICA_F_WHOLE;
  8. water4096 MD, 200 steps under for_dynamics() after tune_capacities:
     finite energies, no list or tile overflow, healthy SCF, the
     conservation gate of phase 5 scaled to the 16 copies, each block
     kernel launched at least once per step; steps/s;
  9. the four fused PIP kernels against their twins, for poly2b and poly3b,
     on the variables the water256 lists give two_body/three_body and on
     4096 seeded rows uniform in [1e-4, 1], on the bounds of
     ops/pip_fused_check.py; device time, the twin's time and the time of
     the default plain evaluator on the same variables. The two tensor-core
     kernels (exp/log and exact-product quadratic forms) are bounded by
     their six bf16 passes at the tensor cores' dense peak plus their CUDA-
     core work, and log kernel / library, effective TFLOP/s, blocks and
     waves at both batches. Every kernel's time is held above its bound;
 10. water256 single point under each fused pip_impl: 'quad_bf16' and
     'vech_pallas' (the default's formula) within PIP_E_TOL_KCAL of phase
     4's two- and three-body energies and REPLICA_F_WHOLE of its forces;
     'quad_pallas' and 'pallas' (exp/log forms) within the golden band;
 11. water256 MD under for_dynamics(pip_impl=...): 200 steps under
     'quad_bf16' with phase 5's checks and conservation gate, 20 steps
     under each of the other three (finite, no overflow, healthy SCF); the
     impl's kernel launched at least twice per step; steps/s.
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
# 3 x the largest |fitted second-half change| of the JAX reference over six
# starts (tools/md_gate_reference.py, float32 CPU; PERF.md)
MD_FIT_TOL_KJ = 6.8
REPS = (2, 2, 4)                  # water4096 = water256 x 2 x 2 x 4
N_COPIES = int(np.prod(REPS))
MD4096_STEPS = 200
# E_tot is extensive and the 16 copies start identical: phase 5's bound
# per copy
MD4096_FIT_TOL_KJ = N_COPIES * MD_FIT_TOL_KJ
REPLICA_E_REL = 1e-4
REPLICA_F_REL = 1e-3
# whole-potential forces of the copies, max |dF| / max |F|: the float32
# 2B/3B quadratic forms round differently with the list length (readings:
# 4.389e-3 on the H100; the water256 float32 forces are 3.130e-3 from
# float64; PERF.md)
REPLICA_F_WHOLE = 6e-3
N_TIMING = 20
N_TIMING_TWIN_BS = 3              # the block twins take ~0.1-1 s per call
# H100 SXM peaks: HBM bytes/s, fp32 FLOP/s on the CUDA cores, dense bf16
# FLOP/s on the tensor cores
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12
# operations per site pair, each arithmetic operation or transcendental
# counted once: the cutoff test of every candidate pair (3 differences,
# minimum image, r^2, sqrt, compare), the rest of the chain per in-cutoff
# pair (K1, K2), and K3's per-pair work (minimum image, projection, 2 x 3
# multiply-adds) on every pair of an active block
OPS_TEST, OPS_K1, OPS_K2, OPS_K3 = 25, 60, 150, 36
SOURCE = 'mbpol_openmm_plugin_tpu_torch/csrc/elec_direct.cu'
SOURCE_BS = 'mbpol_openmm_plugin_tpu_torch/csrc/elec_direct_bs.cu'
SOURCE_PIP = 'mbpol_openmm_plugin_tpu_torch/csrc/pip_fused.cu'
KERNELS = {   # wrapper name: (CUDA kernel name, source, the TPU kernel it replaces)
    'fixed_field_and_scf_factors': (
        'fixed_field_kernel', SOURCE, 'mbpol_openmm_plugin_tpu/ops/elec_pallas.py:315'),
    'direct_energy_force_pot': (
        'direct_efp_kernel', SOURCE, 'mbpol_openmm_plugin_tpu/ops/elec_pallas.py:364'),
    'fixed_field_and_scf_blocks': (
        'fixed_field_bs_kernel', SOURCE_BS, 'mbpol_openmm_plugin_tpu/ops/elec_pallas_bs.py:182'),
    'scf_dipole_field_bs': (
        'scf_field_bs_kernel', SOURCE_BS, 'mbpol_openmm_plugin_tpu/ops/elec_pallas_bs.py:209'),
    'direct_energy_force_pot_bs': (
        'direct_efp_bs_kernel', SOURCE_BS, 'mbpol_openmm_plugin_tpu/ops/elec_pallas_bs.py:249'),
    'pip_energy_grad': (
        'pip_monomial_kernel', SOURCE_PIP, 'mbpol_openmm_plugin_tpu/ops/pip_pallas.py:34'),
    'pip_quad_energy_grad': (
        'pip_quad_explog_kernel', SOURCE_PIP, 'mbpol_openmm_plugin_tpu/ops/pip_pallas.py:105'),
    'pip_quad_product_energy_grad': (
        'pip_quad_product_kernel', SOURCE_PIP, 'mbpol_openmm_plugin_tpu/ops/pip_pallas.py:250'),
    'pip_vech_energy_grad': (
        'pip_quad_vech_kernel', SOURCE_PIP, 'mbpol_openmm_plugin_tpu/ops/pip_pallas.py:317'),
}
# The kernel/twin bounds are in mbpol_openmm_plugin_tpu_torch/ops/elec_direct_check.py and
# ops/pip_fused_check.py.
PIP_RANDOM_ROWS = 4096
PIP_E_TOL_KCAL = 1.0              # 2B and 3B energies, exact-product impls vs the default
PIP_MD_STEPS_SHORT = 20
# operations per (row, monomial) of the monomial expansion: <= 4 adds, one
# exp, one multiply, one add for e, <= 4 adds for g
OPS_MONO = 10
# the tensor-core quadratic forms: bf16 passes of the W product (2 P B^2
# operations each), and CUDA-core operations per (row, basis element): the
# basis value (a multiply; exp/log: an add and an exp), the 3-way bf16 split
# (3 roundings, 2 widenings, 2 subtractions) and the epilogue (m2 wm, its
# double, the energy sum) and the 3-way split of z; the gradient z @ F is
# three more bf16 passes of 2 P B V operations (F is exact in bf16)
QUAD_PASSES, QUAD_GRAD_PASSES = 6, 3
OPS_QUAD_ELEM = {'pip_quad_energy_grad': 2 + 7 + 3 + 7,
                 'pip_quad_product_energy_grad': 1 + 7 + 3 + 7}


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


def loop_ms(torch, fn, n=N_TIMING):
    """Mean time per call of n back-to-back calls between two CUDA events
    (one synchronize at the end): device time once the device, not the
    host, is the slower of the two."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound(n_bytes, n_ops, n_tensor_ops=0, tensor_scheme=None):
    """(least time in ms the card could take, what bounds it): the larger
    of bytes over HBM_BPS and the operations' time, which is the CUDA-core
    operations over FP32_FLOPS plus, for a tensor-core kernel, the bf16
    operations of the passes it issues over BF16_TENSOR_FLOPS (then named
    'operations (<scheme>)')."""
    t_bytes = n_bytes / HBM_BPS
    t_ops = n_ops / FP32_FLOPS + n_tensor_ops / BF16_TENSOR_FLOPS
    by = 'operations' + (f' ({tensor_scheme})' if n_tensor_ops else '')
    return (max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else by)


def kernel_record(name, max_abs, ms, plain_ms, bound_ms_by, library_ms=None):
    cuda_name, source, replaces = KERNELS[name]
    assert ms >= bound_ms_by[0], (name, ms, bound_ms_by)    # faster than the bound: a wrong count
    return dict(name=name, route='cuda', source=source, replaces=replaces,
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms_by[0],
                bound_by=bound_ms_by[1], library_ms=library_ms)


def time_kernel(torch, card, name, kern, plain, n_plain=N_TIMING):
    """(device ms per launch from torch.profiler, or the back-to-back call
    time when the trace has none; the twin's ms per call), logged."""
    cuda_name = KERNELS[name][0]
    dev_ms, kern_loop = kernel_device_ms(torch, kern, cuda_name), loop_ms(torch, kern)
    plain_loop = loop_ms(torch, plain, n_plain)
    call_ms = median_ms(torch, kern)
    log(f'  {name:28s} kernel device time '
        f'{"not in the profiler trace" if dev_ms is None else f"{dev_ms:.4f} ms"}; '
        f'back-to-back per call: kernel {kern_loop:.4f} ms, twin {plain_loop:.4f} ms '
        f'({n_plain} calls); synchronized wrapper call (median): kernel {call_ms:.4f} ms '
        f'({card})')
    return (dev_ms if dev_ms is not None else kern_loop), plain_loop


def kernel_device_ms(torch, fn, kernel):
    """Mean device time of one launch of the CUDA kernel whose name
    contains `kernel` over N_TIMING calls of fn, read from torch.profiler's
    device trace. None when the trace holds no device time for it."""
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


def load_water4096(torch):
    """The water256 fixture repeated REPS times, on the card, float32."""
    from mbpol_openmm_plugin_tpu_torch.system import compute_virtual_sites, replicate
    system, pos = load_water256(torch, torch.device('cuda'), torch.float32)
    big, pos = replicate(system, pos, REPS)
    return big, compute_virtual_sites(big, pos)


def n_in_cutoff(*blocks):
    """Pairs with a nonzero SCF factor: the in-cutoff pairs of this run."""
    return int(sum(((b3 != 0) | (b5 != 0)).sum() for b3, b5 in blocks))


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
    max_abs = {}
    for kname, rows, kout, tout in (
            ('fixed_field_and_scf_factors', check.k1_rows(sites, polarity, k1, t1, t1_64), k1, t1),
            ('direct_energy_force_pot', check.k2_rows(k2, t2), k2, t2)):
        for row in rows:
            log(f'  {kname:28s} {row}')
            if not row.ok:
                failures.append(f'{kname}.{row.output}.{row.entries}.{row.measure}')
        max_abs[kname] = max(float((k - t).abs().max()) for k, t in zip(kout, tout))

    n = sites.shape[0]
    n_pairs, n_in = n * (n - 1), n_in_cutoff((k1[1], k1[2]))
    bounds = {
        'fixed_field_and_scf_factors': bound(n * 32 + n * 12 + 2 * n * n * 4,
                                             n_pairs * OPS_TEST + n_in * OPS_K1),
        'direct_energy_force_pot': bound(n * 32 + n * 12 + n * 20,
                                         n_pairs * OPS_TEST + n_in * OPS_K2)}
    log(f'  N={n}: {n_in} in-cutoff ordered pairs of {n_pairs}')
    timed = (('fixed_field_and_scf_factors',
              lambda: ED.fixed_field_and_scf_factors(sites, consts),
              lambda: ED.fixed_field_and_scf_factors_plain(sites, consts)),
             ('direct_energy_force_pot',
              lambda: ED.direct_energy_force_pot(sites, mu, consts),
              lambda: ED.direct_energy_force_pot_plain(sites, mu, consts)))
    for kname, kern, plain in timed:
        ms, plain_ms = time_kernel(torch, card, kname, kern, plain)
        record[kname] = kernel_record(kname, max_abs[kname], ms, plain_ms, bounds[kname])
        log(f'  {kname:28s} bound {bounds[kname][0]:.4f} ms ({bounds[kname][1]})')
    if failures:
        raise AssertionError(f'kernel/twin mismatch: {failures}')


SINGLE_POINT = dict(nonbonded_method='PME', cutoff=0.9, target_epsilon=1e-4, nlist_skin=0.02,
                    max_iterations=200)


def phase_single_point(torch, card):
    """Phase 4: water256 PME f32 single point against the golden total.
    Returns (potential, energy kJ/mol, forces, per-term energies) for
    phases 7 and 10."""
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
    from mbpol_openmm_plugin_tpu_torch.utils import units

    system, pos = load_water256(torch, torch.device('cuda'), torch.float32)
    pot = MBPol(system, MBPolConfig(**SINGLE_POINT))
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
    assert pot.elec_mode == 'dense' and pot.disp_mode == 'dense'
    assert bool(diag['converged']), 'SCF did not converge'
    assert bool(torch.isfinite(f).all()), 'non-finite forces'
    assert not bool(diag['pair_overflow']) and not bool(diag['triplet_overflow'])
    assert abs(e_kcal - GOLDEN_KCAL) <= GOLDEN_TOL_KCAL, e_kcal
    assert all(n > 0 for n in launches.values()), launches
    return pot, float(e), f, parts


def second_half_fit(e_tot):
    """Change of E_tot over the second half of a chunk (index 0 = chunk
    start) from a least-squares line (tools/md_gate_reference.py)."""
    half = np.asarray(e_tot[(len(e_tot) - 1) // 2:], np.float64)
    return float(np.polyfit(np.arange(len(half), dtype=np.float64), half, 1)[0]
                 * (len(half) - 1))


def phase_md(torch, card, record):
    """Phase 5: 200 NVE steps under MBPolConfig.for_dynamics()."""
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED

    system, pos = load_water256(torch, torch.device('cuda'), torch.float32)
    pot = MBPol(system, MBPolConfig.for_dynamics())
    sim = Simulation(pot, SimulationConfig(dt=0.0002, nlist_rebuild_interval='auto'))
    sim.set_positions(pos)
    torch.cuda.synchronize()
    ED.reset_launch_counts()
    t0 = time.perf_counter()
    out = sim.step(MD_STEPS)      # raises on NaN, list overflow or a failed SCF
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in ED.KERNELS}
    t1 = time.perf_counter()
    pot.energy_forces(sim.state.positions)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t1) * 1e3
    e_tot = out['step_total_energy']
    fit = second_half_fit(e_tot)
    h = MD_STEPS // 2
    log(f'  E_tot at steps 0/{h}/{MD_STEPS}: {e_tot[0]:.4f} / {e_tot[h]:.4f} / '
        f'{e_tot[-1]:.4f} kJ/mol; second half: change {e_tot[-1] - e_tot[h]:+.4f}, fitted '
        f'change {fit:+.4f} kJ/mol (bound |fit| <= {MD_FIT_TOL_KJ}); '
        f'T_end {out["temperature"][-1]:.2f} K')
    log(f'  {MD_STEPS} steps in {wall:.3f} s = {MD_STEPS / wall:.2f} steps/s, including the two '
        f'converged evaluations step() makes at the chunk start and end (one takes '
        f'{cold_ms:.1f} ms) ({card})')
    log(f'  kernel launches during the MD run: {launches}')
    assert np.all(np.isfinite(e_tot)), out
    assert abs(fit) <= MD_FIT_TOL_KJ, fit
    assert all(n >= MD_STEPS for n in launches.values()), launches
    for name, n in launches.items():
        record[name]['launches'] = n
    return MD_STEPS / wall


def water4096_potential(torch, card):
    """The water4096 potential of phases 6 and 8: for_dynamics(), resolved
    by 'auto' on the card, with tune_capacities at the starting positions."""
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    system, pos = load_water4096(torch)
    pot = MBPol(system, MBPolConfig.for_dynamics())
    assert (pot.elec_mode, pot.disp_mode) == ('block', 'pairs'), (pot.elec_mode, pot.disp_mode)
    t0 = time.perf_counter()
    pot.tune_capacities(pos)
    torch.cuda.synchronize()
    log(f'  water4096: {system.n_waters} waters, {pos.shape[0]} sites, box '
        f'{tuple(round(float(b), 5) for b in system.box)} nm, modes {pot.elec_mode}/'
        f'{pot.disp_mode}, PME grid {pot.pme.grid}; tune_capacities '
        f'{time.perf_counter() - t0:.2f} s: tile-pair capacity '
        f'{pot._block_info["tile_pair_capacity"]}, pair/triplet/dispersion-pair caps '
        f'{pot.pair_cap}/{pot.trip_cap}/{pot.disp_pair_cap}')
    return pot, pos


def phase_block_kernels(torch, card, record, pot, pos):
    """Phase 6: the block kernels against their twins at water4096."""
    from mbpol_openmm_plugin_tpu_torch.models import electrostatics as elec
    from mbpol_openmm_plugin_tpu_torch.models import pme
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as BS
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_check as check

    params, block = pot.elec_params, pot._block_info
    charges, _ = elec.assemble_charges(params, pos)
    sites, tiles = pme.block_sites(params, pot.pme, pos, charges, block)
    n, np_ = pos.shape[0], sites.shape[0]
    polarity = torch.as_tensor(params.polarity[block['site_perm']], dtype=pos.dtype,
                               device=pos.device)
    consts = ED.DirectConsts.from_setup(pot.pme, params.thole)
    n_act, cap, n_tiles = int(tiles.n_act), tiles.capacity, np_ // BS.TILE
    log(f'  sorted sites {tuple(sites.shape)}; active tile pairs n_act {n_act} of '
        f'{n_tiles * n_tiles}, capacity {cap} ({cap - n_act} padded entries)')
    assert 0 < n_act <= cap
    checks = check.block_kernel_rows(sites, polarity, tiles, n, consts)
    torch.cuda.synchronize()
    failures = []
    for kname, (rows, _) in checks.items():
        for row in rows:
            log(f'  {kname:28s} {row}')
            if not row.ok:
                failures.append(f'{kname}.{row.output}.{row.entries}.{row.measure}')

    field, s3, s5 = BS.fixed_field_and_scf_blocks(sites, n, tiles, consts)
    mu = (polarity[:, None] * field).contiguous()
    mu_pad = BS.pad_rows(mu, np_)
    torch.cuda.synchronize()
    pairs_act = n_act * BS.TILE * BS.TILE
    valid = (tiles.meta & BS.VALID) > 0           # the blocks K1-bs writes
    n_in = n_in_cutoff((s3[valid], s5[valid]))
    lists = cap * 12 + (n_tiles + 1) * 4
    bounds = {
        'fixed_field_and_scf_blocks': bound(np_ * 32 + lists + n * 12 + 2 * pairs_act * 4,
                                            pairs_act * OPS_TEST + n_in * OPS_K1),
        'scf_dipole_field_bs': bound(np_ * 32 + np_ * 12 + lists + 2 * pairs_act * 4 + n * 12,
                                     pairs_act * OPS_K3),
        'direct_energy_force_pot_bs': bound(np_ * 32 + n * 12 + lists + n * 20,
                                            pairs_act * OPS_TEST + n_in * OPS_K2)}
    log(f'  {n_in} in-cutoff ordered pairs of {pairs_act} in the active blocks')
    timed = (('fixed_field_and_scf_blocks',
              lambda: BS.fixed_field_and_scf_blocks(sites, n, tiles, consts),
              lambda: BS.fixed_field_and_scf_blocks_plain(sites, n, tiles, consts)),
             ('scf_dipole_field_bs',
              lambda: BS.scf_dipole_field_bs(sites, s3, s5, mu_pad, tiles, n, consts),
              lambda: BS.scf_dipole_field_bs_plain(sites, s3, s5, mu_pad, tiles, n, consts)),
             ('direct_energy_force_pot_bs',
              lambda: BS.direct_energy_force_pot_bs(sites, mu, n, tiles, consts),
              lambda: BS.direct_energy_force_pot_bs_plain(sites, mu, n, tiles, consts)))
    for kname, kern, plain in timed:
        ms, plain_ms = time_kernel(torch, card, kname, kern, plain, N_TIMING_TWIN_BS)
        record[kname] = kernel_record(kname, checks[kname][1], ms, plain_ms, bounds[kname])
        log(f'  {kname:28s} bound {bounds[kname][0]:.4f} ms ({bounds[kname][1]})')
    if failures:
        raise AssertionError(f'block kernel/twin mismatch: {failures}')


def phase_replication(torch, card, pot256, e256, f256):
    """Phase 7: water4096 single point against water256 x REPS: energy per
    copy at REPLICA_E_REL; forces at REPLICA_F_REL of max|F| for the terms
    this path changes (block electrostatics, pair dispersion; evaluated
    alone at both sizes), and at REPLICA_F_WHOLE for the whole potential
    (beside it, the water256 float32 forces' error against float64 on the
    CPU, for the record)."""
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    system, pos = load_water4096(torch)
    grid = tuple(g * r for g, r in zip(pot256.pme.grid, REPS))

    def copies_rel(f_big, f_small):
        return float((f_big.reshape(N_COPIES, -1, 3) - f_small[None]).abs().max()
                     / f_small.abs().max())

    pot = MBPol(system, MBPolConfig(pme_grid=grid, **SINGLE_POINT)).tune_capacities(pos)
    assert pot.elec_mode == 'block' and pot.pme.alpha == pot256.pme.alpha
    t0 = time.perf_counter()
    e, f, _, diag = pot.energy_forces(pos)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    e_rel = abs(float(e) / N_COPIES - e256) / abs(e256)
    f_rel = copies_rel(f, f256)

    slice_terms = dict(SINGLE_POINT, terms=('electrostatics', 'dispersion'))
    sys256, pos256 = load_water256(torch, torch.device('cuda'), torch.float32)
    fs256 = MBPol(sys256, MBPolConfig(**slice_terms)).energy_forces(pos256)[1]
    fs = MBPol(system, MBPolConfig(pme_grid=grid, **slice_terms)).tune_capacities(
        pos).energy_forces(pos)[1]
    fs_rel = copies_rel(fs, fs256)
    # for the record beside REPLICA_F_WHOLE: the float32 forces' own error
    sys64, pos64 = load_water256(torch, torch.device('cpu'), torch.float64)
    f64 = MBPol(sys64, MBPolConfig(**SINGLE_POINT), device='cpu').energy_forces(pos64)[1]
    f32_err = float((f256.cpu().double() - f64).abs().max() / f64.abs().max())
    log(f'  PME grid {grid}; E {float(e):.4f} kJ/mol = {float(e) / N_COPIES:.5f} per water256 '
        f'copy vs {e256:.5f}: relative {e_rel:.3e} (bound {REPLICA_E_REL}); SCF iterations '
        f'{int(diag["iterations"])}; tile pairs {int(diag["elec_tile_pairs"])}; wall '
        f'{wall * 1e3:.1f} ms ({card})')
    log(f'  forces, max |dF| / max |F| over the {N_COPIES} copies: electrostatics + dispersion '
        f'{fs_rel:.3e} (bound {REPLICA_F_REL}); whole potential {f_rel:.3e} (bound '
        f'{REPLICA_F_WHOLE}; the water256 float32 forces are {f32_err:.3e} from float64)')
    assert bool(diag['converged'])
    assert not any(bool(v) for k, v in diag.items() if k.endswith('_overflow')), diag
    assert e_rel <= REPLICA_E_REL, e_rel
    assert fs_rel <= REPLICA_F_REL, fs_rel
    assert f_rel <= REPLICA_F_WHOLE, f_rel


def phase_md4096(torch, card, record, pot, pos):
    """Phase 8: water4096 NVE steps under for_dynamics() in block/pairs mode,
    with phase 5's conservation gate per copy."""
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as BS

    sim = Simulation(pot, SimulationConfig(dt=0.0002, nlist_rebuild_interval='auto'))
    sim.set_positions(pos)
    torch.cuda.synchronize()
    BS.reset_launch_counts()
    t0 = time.perf_counter()
    out = sim.step(MD4096_STEPS)   # raises on NaN, list/tile overflow or a failed SCF
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in BS.KERNELS}
    e_tot = out['step_total_energy']
    fit = second_half_fit(e_tot)
    h = MD4096_STEPS // 2
    log(f'  E_tot at steps 0/{h}/{MD4096_STEPS}: {e_tot[0]:.4f} / {e_tot[h]:.4f} / '
        f'{e_tot[-1]:.4f} kJ/mol; second half: change {e_tot[-1] - e_tot[h]:+.4f}, fitted '
        f'change {fit:+.4f} kJ/mol = {fit / N_COPIES:+.4f} per water256 copy (bound |fit| <= '
        f'{MD4096_FIT_TOL_KJ:.1f}); T_end {out["temperature"][-1]:.2f} K')
    log(f'  {MD4096_STEPS} steps in {wall:.3f} s = {MD4096_STEPS / wall:.3f} steps/s, including '
        f'the two converged evaluations step() makes at the chunk start and end ({card})')
    log(f'  kernel launches during the MD run: {launches}; peak device memory '
        f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB')
    assert np.all(np.isfinite(e_tot)), out
    assert abs(fit) <= MD4096_FIT_TOL_KJ, fit
    assert all(n >= MD4096_STEPS for n in launches.values()), launches
    for name, n in launches.items():
        record[name]['launches'] = n


def pip_variables(torch):
    """{polynomial: x [P, V]} that two_body/three_body hand to pip_apply at
    water256 with the lists of for_dynamics() (padded to the list
    capacities, as in the MD phases)."""
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.models.three_body import three_body_variables
    from mbpol_openmm_plugin_tpu_torch.models.two_body import two_body_variables
    system, pos = load_water256(torch, torch.device('cuda'), torch.float32)
    pot = MBPol(system, MBPolConfig.for_dynamics())
    (pl, tl), diag = pot.build_neighbor_lists(pos)
    with torch.no_grad():
        x = {'poly2b': two_body_variables(system, pos, pl[0], pl[1]).contiguous(),
             'poly3b': three_body_variables(system, pos, tl[0], tl[1]).contiguous()}
    log(f'  water256 lists: {int(diag["n_pairs"])} pairs in {pot.pair_cap} rows, '
        f'{int(diag["n_triplets"])} triplets in {pot.trip_cap} rows')
    return x


def phase_pip_kernels(torch, card, record):
    """Phase 9: the fused PIP kernels against their twins."""
    from mbpol_openmm_plugin_tpu_torch.ops import pip_fused as PF
    from mbpol_openmm_plugin_tpu_torch.ops import pip_fused_check as check
    from mbpol_openmm_plugin_tpu_torch.ops import polyeval

    real = pip_variables(torch)
    failures = []
    max_abs = {k.__name__: 0.0 for k in PF.KERNELS}
    for poly, x in real.items():
        rng = np.random.default_rng(x.shape[1])
        seeded = torch.as_tensor(
            rng.uniform(1e-4, 1.0, (PIP_RANDOM_ROWS, x.shape[1])).astype(np.float32),
            device=x.device)
        for what, xs in (('water256', x), ('seeded', seeded)):
            for wrapper in PF.KERNELS:
                kname = wrapper.__name__
                rows, err = check.kernel_rows(wrapper, poly, xs, physical=what == 'water256')
                torch.cuda.synchronize()
                if what == 'water256':
                    max_abs[kname] = max(max_abs[kname], err)
                for row in rows:
                    log(f'  {kname:28s} {poly} {what:8s} [{xs.shape[0]:5d}] {row}')
                    if not row.ok:
                        failures.append(f'{kname}.{poly}.{what}.{row.output}.{row.measure}')

    # the default plain evaluator of the same function on the same variables
    library = {PF.pip_energy_grad: polyeval.pip_energy_and_grad}
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for poly, x in real.items():
        p, v = x.shape
        b, nmono = polyeval.load_quad(poly)[0].shape[0], polyeval.load_pip(poly).nmono
        io_bytes = 4 * p * (2 * v + 1)
        fp32_bound = bound(io_bytes + 4 * b * b, 2 * p * b * b + 2 * p * b * v)
        bounds = {'pip_vech_energy_grad': fp32_bound,
                  'pip_energy_grad': bound(io_bytes + 5 * 4 * nmono, OPS_MONO * p * nmono)}
        tables = PF.quad_kernel_tables(poly)
        table_bytes = sum(2 * int(np.prod(t.shape)) for t in tables)
        for kname, elem in OPS_QUAD_ELEM.items():
            bounds[kname] = bound(io_bytes + table_bytes, p * (b * elem + v),
                                  2 * p * b * (QUAD_PASSES * b + QUAD_GRAD_PASSES * v),
                                  f'bf16 x {QUAD_PASSES}')
        for wrapper in PF.KERNELS:
            kname = wrapper.__name__
            lib = library.get(wrapper, polyeval.pip_quad_energy_and_grad)
            ms, plain_ms = time_kernel(torch, card, kname, lambda: wrapper(poly, x),
                                       lambda: PF.PLAIN[wrapper](poly, x), N_TIMING_TWIN_BS)
            lib_ms = loop_ms(torch, lambda: lib(x, poly))
            log(f'  {kname:28s} {poly} [{p}, {v}]: bound {bounds[kname][0]:.4f} ms '
                f'({bounds[kname][1]}); {lib.__name__} on the same variables '
                f'{lib_ms:.4f} ms per call ({card})')
            if kname in OPS_QUAD_ELEM:
                blocks, waves = PF.quad_launch_shape(p, n_sms)
                log(f'  {kname:28s} {poly} [{p}, {v}]: kernel {ms:.4f} ms, bound '
                    f'{bounds[kname][0]:.4f} ms (as plain fp32 operations it was '
                    f'{fp32_bound[0]:.4f} ms), twin {plain_ms:.4f} ms, library {lib_ms:.4f} ms, '
                    f'kernel / library {ms / lib_ms:.3f}, '
                    f'{2.0 * p * b * b / ms / 1e9:.1f} TFLOP/s effective (2 P B^2 over the '
                    f'kernel time), {blocks} blocks = {waves:.2f} waves of '
                    f'{PF.QUAD_BLOCKS_PER_SM} x {n_sms} ({card})')
            assert ms >= bounds[kname][0], (kname, poly, ms, bounds[kname])
            if poly == 'poly3b':       # the record holds the larger polynomial's shape
                record[kname] = kernel_record(kname, max_abs[kname], ms, plain_ms,
                                              bounds[kname], lib_ms)
    if failures:
        raise AssertionError(f'PIP kernel/twin mismatch: {failures}')


def phase_pip_single_point(torch, card, e256, f256, parts256):
    """Phase 10: the water256 single point under each fused pip_impl."""
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.ops import pip_fused as PF
    from mbpol_openmm_plugin_tpu_torch.utils import units

    kcal = units.KJ_PER_MOL_TO_KCAL_PER_MOL
    system, pos = load_water256(torch, torch.device('cuda'), torch.float32)
    for impl, wrapper in PF.WRAPPERS.items():
        pot = MBPol(system, MBPolConfig(pip_impl=impl, **SINGLE_POINT))
        PF.reset_launch_counts()
        e, f, parts, diag = pot.energy_forces(pos)
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in PF.KERNELS}
        d2, d3 = (float(parts[k] - parts256[k]) * kcal for k in ('two_body', 'three_body'))
        f_rel = float((f - f256).abs().max() / f256.abs().max())
        e_kcal = float(e) * kcal
        log(f'  pip_impl={impl!r}: total {e_kcal:.4f} kcal/mol; against the default: two-body '
            f'{d2:+.4f}, three-body {d3:+.4f} kcal/mol, forces max |dF| / max |F| {f_rel:.3e}; '
            f'launches {launches}')
        assert bool(diag['converged']) and bool(torch.isfinite(f).all())
        assert not bool(diag['pair_overflow']) and not bool(diag['triplet_overflow'])
        assert launches == {k.__name__: 2 * (k is wrapper) for k in PF.KERNELS}, launches
        assert abs(e_kcal - GOLDEN_KCAL) <= GOLDEN_TOL_KCAL, e_kcal
        if impl in ('quad_bf16', 'vech_pallas'):
            assert abs(d2) <= PIP_E_TOL_KCAL and abs(d3) <= PIP_E_TOL_KCAL, (d2, d3)
            assert f_rel <= REPLICA_F_WHOLE, f_rel


def phase_pip_md(torch, card, record, quad_steps_per_s):
    """Phase 11: water256 MD under each fused pip_impl."""
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.ops import pip_fused as PF

    system, pos = load_water256(torch, torch.device('cuda'), torch.float32)
    for impl, wrapper in PF.WRAPPERS.items():
        steps = MD_STEPS if impl == 'quad_bf16' else PIP_MD_STEPS_SHORT
        pot = MBPol(system, MBPolConfig.for_dynamics(pip_impl=impl))
        sim = Simulation(pot, SimulationConfig(dt=0.0002, nlist_rebuild_interval='auto'))
        sim.set_positions(pos)
        torch.cuda.synchronize()
        PF.reset_launch_counts()
        t0 = time.perf_counter()
        out = sim.step(steps)         # raises on NaN, list overflow or a failed SCF
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in PF.KERNELS}
        e_tot = out['step_total_energy']
        log(f'  pip_impl={impl!r}: {steps} steps in {wall:.3f} s = {steps / wall:.2f} steps/s '
            f"(phase 5, the default 'quad': {quad_steps_per_s:.2f}) ({card}); E_tot "
            f'{e_tot[0]:.4f} -> {e_tot[-1]:.4f} kJ/mol, T_end {out["temperature"][-1]:.2f} K; '
            f'launches {launches}')
        assert np.all(np.isfinite(e_tot)), out
        assert launches[wrapper.__name__] >= 2 * steps, launches
        assert sum(launches.values()) == launches[wrapper.__name__], launches
        if steps == MD_STEPS:
            fit = second_half_fit(e_tot)
            log(f'    second half: change {e_tot[-1] - e_tot[steps // 2]:+.4f}, fitted change '
                f'{fit:+.4f} kJ/mol (bound |fit| <= {MD_FIT_TOL_KJ})')
            assert abs(fit) <= MD_FIT_TOL_KJ, fit
        record[wrapper.__name__]['launches'] = launches[wrapper.__name__]


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
        if any(w in line for w in ('registers', 'spill', 'Compiling', 'arning')):
            log('  ' + line.strip())

    record = {}
    log('== phase 3: kernels vs twins (water256, float32)')
    phase_kernels(torch, card, record)
    log('== phase 4: single point (water256 PME, float32)')
    pot256, e256, f256, parts256 = phase_single_point(torch, card)
    log(f'== phase 5: MD (water256, for_dynamics, {MD_STEPS} Verlet steps at 0.2 fs)')
    quad_steps_per_s = phase_md(torch, card, record)
    log('== phase 6: block kernels vs twins (water4096, float32)')
    pot4096, pos4096 = water4096_potential(torch, card)
    phase_block_kernels(torch, card, record, pot4096, pos4096)
    log('== phase 7: replication (water4096 single point vs water256 x 2 x 2 x 4)')
    phase_replication(torch, card, pot256, e256, f256)
    log(f'== phase 8: MD (water4096, for_dynamics, block/pairs, {MD4096_STEPS} Verlet steps '
        f'at 0.2 fs)')
    torch.cuda.reset_peak_memory_stats()
    phase_md4096(torch, card, record, pot4096, pos4096)
    del pot4096, pos4096
    torch.cuda.empty_cache()
    log('== phase 9: fused PIP kernels vs twins (water256 lists and seeded rows, float32)')
    phase_pip_kernels(torch, card, record)
    log('== phase 10: single point under each fused pip_impl (water256 PME, float32)')
    phase_pip_single_point(torch, card, e256, f256, parts256)
    log(f'== phase 11: MD under each fused pip_impl (water256, for_dynamics; {MD_STEPS} Verlet '
        f"steps under 'quad_bf16', {PIP_MD_STEPS_SHORT} under the others)")
    phase_pip_md(torch, card, record, quad_steps_per_s)

    log(card)
    log(json.dumps({'kernels': [record[k] for k in KERNELS]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
