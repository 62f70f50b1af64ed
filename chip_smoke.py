#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (mbpol_openmm_plugin_tpu_torch).

Drives the port's paths on one CUDA card, in float32, through the entry
points a user calls (MBPol, tune_capacities, energy_forces, Simulation,
PIMDSimulation, REMDSimulation, virial_pressure):
MB-pol water256 bulk PME in the dense electrostatics mode, water4096 (the
water256 fixture repeated 2 x 2 x 4, 16,384 sites) in the block-sparse
mode that 'auto' picks above 2560 waters on a card, water256 again with
the 2B/3B polynomials evaluated by each fused kernel
(MBPolConfig.pip_impl), the cluster (NoCutoff) path on water clusters up
to 256 waters, r-RESPA on water256 PME, path-integral MD (contracted,
full-bead and NPT) and replica exchange. It builds the hand-written CUDA kernels from csrc/
and holds each against its plain PyTorch twin at the shapes its path gives
it.

Phases (any failure raises and the script exits non-zero):
  1. card identity (nvidia-smi name and power limit), TF32 off;
  2. kernel build (one nvcc per source, in parallel; timed, with the
     compiler's resource report and warnings);
  3. the dense kernels K1/K2 (triangular form, tile sum included) against
     their twins, full and triangular (float32 and float64), on the entry
     sets and bounds of ops/elec_direct_check.py, on the water256 fixture
     and on water2048 (the fixture repeated 2 x 2 x 2, 8,192 sites, dense);
     s3/s5 exactly symmetric; each kernel's bound from the unordered
     in-cutoff pairs (beside it, what the route touches: the pairs it tests
     and its partials scratch), its device time (torch.profiler) beside the
     time before the triangular form and the device time of an empty
     kernel launch, and the twin's time per call;
  4. water256 single point vs the golden -2270.8889 +/- 20 kcal/mol;
  5. water256 MD, 200 steps under for_dynamics(): finite energies, no list
     overflow, healthy SCF, energy conservation after the ASPC start-up
     transient (|fitted change of E_tot over steps 100..200| <= MD_FIT_TOL_KJ,
     see PERF.md), and K1/K2 launched at least once per step;
  6. the block kernels K1-bs/K3-bs/K2-bs against their twins at water4096,
     in the sorted order tune_capacities picks (the padded list holds
     inactive-pair padding), on the entry sets of ops/elec_direct_check.py
     (K1-bs's s3/s5 lines spread into blocks); the live share of the
     (water, cluster) lines the kernels test, the line capacity, the live
     lines per slab and the s3/s5 bytes allocated; each kernel's bound from
     the in-cutoff pairs of this run (beside it, what the routes touch:
     all candidates, live lines, whole blocks), and its device time
     (cluster-box pre-pass included) beside the time before the live-line
     layout;
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
     the default plain evaluator on the same variables. The three quadratic
     forms (exp/log, exact-product and vech bases) are bounded by the
     larger of their six bf16 passes at the tensor cores' dense peak and
     their CUDA-core work (the two units run side by side), the monomial
     kernel by the largest of its bytes, the function's own CUDA-core
     operations and its expf count over the transcendental unit's rate (the
     cost of its route, the dense bf16 x 3 product with a sparse exponent
     matrix, is logged beside the bound and is not part of it); each logs
     kernel / library, its effective rate, blocks and waves at both
     batches. Every kernel's time is held above its bound;
 10. water256 single point under each fused pip_impl: 'quad_bf16' and
     'vech_pallas' (the default's formula) within PIP_E_TOL_KCAL of phase
     4's two- and three-body energies and REPLICA_F_WHOLE of its forces;
     'quad_pallas' and 'pallas' (exp/log forms) within the golden band;
 11. water256 MD under for_dynamics(pip_impl=...): 200 steps under
     'quad_bf16' with phase 5's checks and conservation gate, 20 steps
     under each of the other three (finite, no overflow, healthy SCF); the
     impl's kernel launched at least twice per step; steps/s.
 12. dynamic box: K1/K2 at 1.01 and 0.99 times the water256 box (each
     water's centroid scaled) against their twins at that box, on the entry
     sets of ops/elec_direct_check.py; the water256 single point at 1.01 x
     the box against an MBPol built in that box with the same PME grid,
     alpha and list capacities (energy and forces within IDENTITY_REL); the
     wrappers and an evaluation refuse a box under twice the cutoff;
 13. NVT: water256 under for_dynamics(), Langevin at 300 K, friction
     100/ps, cm_motion_interval=1, 400 steps in reports of 10 from
     set_velocities_to_temperature(300): finite energies, healthy SCF, no
     overflow, K1/K2 launched every step, the mean kinetic temperature over
     steps 201..400 within 300 +/- NVT_T_TOL_K (beside it, the JAX
     reference reading of tools/md_ensemble_reference.py); Andersen at
     1000/ps, 100 steps, the same checks over steps 51..100; steps/s;
 14. NPT: water256, Langevin 300 K at 1/ps, 1 bar, barostat_interval=25,
     500 steps: 20 moves attempted, at least one accepted, |dV/V| < 5%,
     after each accepted move the state's energy equal to a fresh converged
     evaluation at its positions and box (NPT_E_REL); a 100-step run equal
     bit for bit to 50 steps, a checkpoint file, a new Simulation and 50
     more; L-BFGS minimize_energy, 50 iterations: the energy never rises,
     the RMS force falls; steps/s;
 15. water4096 NPT: block + pairs after tune_capacities, Langevin 300 K at
     1/ps, 1 bar, barostat_interval=10, 50 steps: finite energies, healthy
     SCF, no list, tile, line or pair overflow, K1-bs/K3-bs/K2-bs launched
     every step, 5 moves attempted, the accepted moves' energies as in
     phase 14; the acceptance count and steps/s;
 16. cluster (NoCutoff) single points, float32 on the card: the water3
     total (-8.78893485 +/- 0.1 kcal/mol) and 4-site electrostatics
     (-15.818784 +/- 0.1), the 3-site water3 electrostatics (-7.08652 +/-
     0.01) under SOR and DIIS with fewer DIIS iterations; the water14
     cluster and the water256 droplet (the water256 fixture made whole,
     without a box, after tune_capacities) under the default pip_impl and
     'quad_bf16' (kernel #10 on non-periodic lists), each term and the
     forces against the port's CPU float64 evaluation of the same float32
     positions within F32_BOUND_FACTOR x the JAX package's own float32
     distance (JAX_F32_DISTANCE, tools/cluster_respa_reference.py); the
     droplet's system moments and its potential on 64 points of a 2 nm
     sphere, bounded the same way; DIIS against SOR at the droplet and at
     the water256 PME single point, both at eps 1e-6: the electrostatics
     within the bound of that input's float32 electrostatics, fewer DIIS
     iterations;
 17. cluster MD: the water14 cluster under the flat-bottom restraint
     (0.75 nm, 1000 kJ/mol/nm^2), Langevin 300 K at 1/ps, 500 steps
     (finite, healthy; mean T reported); the water256 droplet under
     for_dynamics(nonbonded_method='NoCutoff'), 200 NVE steps from rest,
     |second-half fit| <= 3 x the largest JAX float32 reading
     (DROPLET_FIT_READINGS); steps/s;
 18. r-RESPA on water256 PME (for_dynamics; K1/K2 on every rung that
     holds the electrostatics): (a) two-level, inner 2, outer 0.4 fs, 100
     outer steps NVE, the fit gated at 3 x the largest JAX reading
     (RESPA_FIT_READINGS); (b) three-level, mid 2, inner 2, outer 0.8 fs,
     50 outer steps under the polarization on the 'mid' and on the 'inner'
     rung with nlist_rebuild_interval=2 (groups end every 2 outer steps, so
     the rungs' forces are carried across them): finite, healthy, fit
     reported; (c) two-level Langevin 300 K at 100/ps, 200 outer steps,
     mean T over the second half within 300 +/- 30 K. Each run prints outer
     and base-step-equivalent steps/s beside phase 5's rate and the K1/K2
     launches per outer step.
 19. the captured step: for water256 (dense, 200 steps) and water4096
     (block + pairs after tune_capacities, 50 steps), the same steps from
     the same state run eagerly (Simulation(..., _eager=True)) and
     captured: E_tot traces and final positions and velocities equal bit
     for bit; the captured groups run under
     torch.cuda.set_sync_debug_mode('error') (a synchronizing call raises;
     the warm-up step and the capture excepted); wall ms per step of each,
     in the order eager / captured / captured / eager, steps/s and the
     speedup, the capture time.
 20. contracted PIMD at water256 (bench.py:373-478): for_dynamics(scf_method=
     'sor') after tune_capacities(margin=1.3), 8 beads contracted to 1, PILE
     300 K, dt 0.1 fs, lists every 25 steps, spread 0.002 nm; 1000
     health-checked steps, then a timed 100-step window; the same with 24
     beads: finite, 0 < KE_cv < 1.5 N n kT, KE_cv over the classical
     3/2 N kT > 1.3, |window drift of E_tot| < 400 kJ/mol, KE_cv(8)/KE_cv(24)
     in (0.55, 1.05), K1/K2 once per step; steps/s beside phase 5's;
 21. Hamiltonian RPMD (thermostat 'none') with 8 full beads at water256,
     200 steps: |second-half fit of the ring-polymer Hamiltonian| <= 3 x the
     largest JAX float32 reading (HAM_FIT_READINGS,
     tools/pimd_remd_reference.py), K1/K2 8 times a step; 20 steps captured
     against eager, bit for bit;
 22. NPT-PIMD (8 -> 1, PILE, 1 bar, a move every 25 steps, 500 steps): 20
     moves, >= 1 accepted, |dV/V| < 5%, each accepted move's per-bead
     energies and forces equal to a fresh converged evaluation; 50 steps +
     a checkpoint file + a new PIMDSimulation + 50 equal to 100, bit for
     bit; virial_pressure at the fixture against the JAX float64 jvp: the
     port's CPU float64 within 1e-6 of |dU/dlambda|, the card's float32
     within 2 x the JAX float32 distance; the rpmd_virial_pressure of a
     short 8-bead run (not gated);
 23. REMD, eager: water256 (bench.py:481-533) at R = 1 and 2 and the water14
     cluster (bench.py:535-630) at R = 1 and 8, each block a health-checked
     run(1): finite, no list overflow, each block's walkers an even/odd
     involution of its accepts; one block after a checkpoint bit for bit;
     replica-steps/s, ladder efficiency, acceptance per pair.
Each phase prints its wall time and the script its total.
Phases 5, 8, 11, 13-15, 17 and 20-22 run each step as a replay of one CUDA
graph (Simulation.captured, PIMDSimulation.captured; the kernel wrappers'
launch counts include the replays); phases 18 (r-RESPA) and 23 (REMD) run
eagerly.
The last two lines are a JSON summary of the kernels and
{"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py     (needs one CUDA card; no arguments)
"""
import contextlib
import json
import os
import sys
import time

import numpy as np

from mbpol_openmm_plugin_tpu_torch.tools.dense_probe import (OPS_K1, OPS_K2, OPS_TEST, TRANS_K1,
                                                           TRANS_K2, dense_bounds)
from mbpol_openmm_plugin_tpu_torch.tools.timing import (BF16_TENSOR_FLOPS, FP32_FLOPS, HBM_BPS,
                                                        MUFU_PER_CLOCK_PER_SM, bound, card_line,
                                                        kernel_device_ms, loop_ms, median_ms,
                                                        transcendental_rate)
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
# the peaks, the operations per pair of the chain (OPS_TEST, OPS_K1,
# OPS_K2, TRANS_K1, TRANS_K2) and the dense kernels' bounds are those of
# tools/timing.py and tools/dense_probe.py; K3's per-pair work (minimum
# image, projection, 2 x 3 multiply-adds), charged like theirs to the
# in-cutoff pairs of this run:
OPS_K3 = 36
# device ms per launch of the dense kernels at water256 before the
# triangular form (PERF.md section 6, rows 1-2), logged beside this run's
DENSE_MS_BEFORE = {'fixed_field_and_scf_factors': 0.0132, 'direct_energy_force_pot': 0.0180}
DENSE_REPS = {'water256': (1, 1, 1), 'water2048': (2, 2, 2)}
# device ms per launch of the block kernels before the live-line layout of
# s3/s5 (this phase's reading of the earlier design, with s3/s5 as whole
# blocks; PERF.md section 6), logged beside this run's
BS_MS_BEFORE = {'fixed_field_and_scf_lines': 1.1152, 'scf_dipole_field_bs': 0.2264,
                'direct_energy_force_pot_bs': 0.2578}
# kernels a wrapper launches besides its own, whose device time is part of
# the wrapper's (the dense kernels' tile sum, the cluster boxes of the
# culling test)
HELPER_KERNELS = {'fixed_field_and_scf_factors': ('tile_sum_kernel',),
                  'direct_energy_force_pot': ('tile_sum_kernel',),
                  'fixed_field_and_scf_lines': ('cluster_boxes_kernel',),
                  'direct_energy_force_pot_bs': ('cluster_boxes_kernel',)}
SOURCE = 'mbpol_openmm_plugin_tpu_torch/csrc/elec_direct.cu'
SOURCE_BS = 'mbpol_openmm_plugin_tpu_torch/csrc/elec_direct_bs.cu'
SOURCE_PIP = 'mbpol_openmm_plugin_tpu_torch/csrc/pip_fused.cu'
KERNELS = {   # wrapper name: (CUDA kernel name, source, the TPU kernel it replaces)
    'fixed_field_and_scf_factors': (
        'fixed_field_tri_kernel', SOURCE, 'mbpol_openmm_plugin_tpu/ops/elec_pallas.py:315'),
    'direct_energy_force_pot': (
        'direct_efp_tri_kernel', SOURCE, 'mbpol_openmm_plugin_tpu/ops/elec_pallas.py:364'),
    'fixed_field_and_scf_lines': (
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
# the monomial expansion, as the function needs it whatever the route:
# CUDA-core operations per (row, monomial): 3 adds of factor logs, the
# multiply by c, the add into e and one multiply-add into g per factor slot
# (an exponent matrix row has at most MONO_SLOTS non-zeros); and one expf
# per (row, monomial) on the transcendental unit, MUFU_PER_CLOCK_PER_SM
# results per clock per SM at the card's maximum SM clock. What the kernel's
# route adds to that is logged and bounds nothing: the 3-way bf16 split of mc
# (3 roundings, 2 widenings, 2 subtractions), V + 1 adds of the sums per (row,
# tile of MONO_TILE monomials), and three dense bf16 passes of
# 2 P M (V + 1) tensor operations.
MONO_SLOTS = 4
OPS_MONO = 3 + 1 + 1 + MONO_SLOTS
OPS_MONO_SPLIT = 7
MONO_TILE, MONO_PASSES = 16, 3
# the tensor-core quadratic forms: bf16 passes of the W product (2 P B^2
# operations each), and CUDA-core operations per (row, basis element): the
# basis value (a multiply; exp/log: an add and an exp), the 3-way bf16 split
# (3 roundings, 2 widenings, 2 subtractions) and the epilogue (m2 wm, its
# double, the energy sum) and the 3-way split of z; the gradient z @ F is
# three more bf16 passes of 2 P B V operations (F is exact in bf16)
QUAD_PASSES, QUAD_GRAD_PASSES = 6, 3
OPS_QUAD_ELEM = {'pip_quad_energy_grad': 2 + 7 + 3 + 7,
                 'pip_quad_product_energy_grad': 1 + 7 + 3 + 7,
                 'pip_vech_energy_grad': 1 + 7 + 3 + 7}
# phases 12-15: the box scales of the dynamic-box checks; an evaluation at
# box b against an MBPol built in box b (same grid, alpha and capacities:
# the same padded lists and float32 sums); the NVT gate and the JAX
# reference reading beside it (tools/md_ensemble_reference.py: mean kinetic
# temperature over the second half of 400 steps, three seeds, JAX f32 on
# the CPU; PERF.md); the accepted moves' energy against a fresh evaluation
BOX_SCALES = (1.01, 0.99)
IDENTITY_REL = 1e-6
NVT_T_K = 300.0
NVT_T_TOL_K = 30.0
NVT_STEPS, NVT_REPORT = 400, 10
ANDERSEN_STEPS = 100
NVT_REFERENCE = 'seeds 0 / 1 / 2: 300.721 / 302.472 / 295.970 K, mean 299.721 K'
NPT_STEPS, NPT_INTERVAL = 500, 25
NPT_DV_MAX = 0.05
NPT_E_REL = 1e-5
CHECKPOINT_STEPS = 100
MINIMIZE_ITERATIONS = 50
NPT4096_STEPS, NPT4096_INTERVAL = 50, 10


def log(*a):
    print(*a, flush=True)


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
    helpers = HELPER_KERNELS.get(name, ())
    dev = kernel_device_ms(kern, cuda_name, N_TIMING, helpers)
    dev_ms = dev.ms
    if helpers and dev_ms is not None:
        log(f'    {cuda_name}: {dev.kernel_ms:.4f} ms, {"/".join(helpers)}: '
            f'{dev.helper_ms:.4f} ms per launch ({dev.launches} launches traced)')
    kern_loop = loop_ms(kern, N_TIMING)
    plain_loop = loop_ms(plain, n_plain)
    call_ms = median_ms(kern, N_TIMING)
    log(f'  {name:28s} kernel device time '
        f'{"not in the profiler trace" if dev_ms is None else f"{dev_ms:.4f} ms"}; '
        f'back-to-back per call: kernel {kern_loop:.4f} ms, twin {plain_loop:.4f} ms '
        f'({n_plain} calls); synchronized wrapper call (median): kernel {call_ms:.4f} ms '
        f'({card})')
    return (dev_ms if dev_ms is not None else kern_loop), plain_loop


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


def empty_launch_ms(torch):
    """Device time of one empty kernel launch (the card's floor per launch)."""
    from mbpol_openmm_plugin_tpu_torch.ops import _build
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    return kernel_device_ms(lambda: lib.mbpol_empty_launch(stream), 'empty_kernel', N_TIMING).ms


def phase_kernels(torch, card, record):
    """Phase 3: K1/K2 against their twins at water256 and water2048."""
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_check as check
    from mbpol_openmm_plugin_tpu_torch.tools.dense_probe import dense_inputs

    floor = empty_launch_ms(torch)
    rate = transcendental_rate()
    tile = ED.TILE
    log(f'  empty kernel launch: {floor:.4f} ms device time (the card\'s floor per launch, '
        f'bounds nothing); tile {tile} sites')
    failures = []
    for size, reps in DENSE_REPS.items():
        sites, polarity, consts = dense_inputs(reps)
        n = sites.shape[0]
        log(f'  {size}: sites {tuple(sites.shape)} {sites.dtype}, cutoff {consts.cutoff} nm, '
            f'alpha {consts.alpha:.6f} 1/nm, box {consts.box[0]:.5f} nm')
        k1 = ED.fixed_field_and_scf_factors(sites, consts)
        torch.cuda.synchronize()
        tri1 = ED.fixed_field_and_scf_factors_tri_plain(sites, consts)
        tri1_64 = ED.fixed_field_and_scf_factors_tri_plain(sites.double(), consts)
        # induced dipoles of realistic size: polarity times the direct field
        mu = (polarity[:, None] * tri1[0]).contiguous()
        k2 = ED.direct_energy_force_pot(sites, mu, consts)
        torch.cuda.synchronize()
        tri2 = ED.direct_energy_force_pot_tri_plain(sites, mu, consts)
        sym = all(bool(torch.equal(m, m.T)) and not bool(m.diagonal().any()) for m in k1[1:])
        log(f'  {size}: s3, s5 exactly symmetric with a zero diagonal: {sym}')
        if not sym:
            failures.append(f'{size}.symmetric')
        checks = [('triangular', 'fixed_field_and_scf_factors',
                   check.k1_rows(sites, polarity, k1, tri1, tri1_64), k1, tri1),
                  ('triangular', 'direct_energy_force_pot', check.k2_rows(k2, tri2), k2, tri2)]
        if size == 'water256':
            full1 = ED.fixed_field_and_scf_factors_plain(sites, consts)
            full1_64 = ED.fixed_field_and_scf_factors_plain(sites.double(), consts)
            full2 = ED.direct_energy_force_pot_plain(sites, mu, consts)
            checks += [('full', 'fixed_field_and_scf_factors',
                        check.k1_rows(sites, polarity, k1, full1, full1_64), k1, full1),
                       ('full', 'direct_energy_force_pot', check.k2_rows(k2, full2), k2, full2)]
        max_abs = {}
        for twin, kname, rows, kout, tout in checks:
            for row in rows:
                log(f'  {size} {kname:28s} vs {twin:10s} {row}')
                if not row.ok:
                    failures.append(f'{size}.{kname}.{twin}.{row.output}.{row.entries}.'
                                    f'{row.measure}')
            err = max(float((k - t).abs().max()) for k, t in zip(kout, tout))
            max_abs[kname] = max(max_abs.get(kname, 0.0), err)

        # bounds: the test and chain of each unordered in-cutoff pair once
        n_in = n_in_cutoff((k1[1], k1[2])) // 2
        nt = -(-n // tile)
        bounds = dense_bounds(n, n_in, rate)
        n_tested = n * (n - 1) // 2
        log(f'  {size}: {n_in} unordered in-cutoff pairs of {n_tested} ({n_in / n_tested:.4%}); '
            f'what the route touches (bounds nothing): it tests all {n_tested} unordered pairs '
            f'({n_tested * OPS_TEST / FP32_FLOPS * 1e3:.4f} ms of operations) in '
            f'{nt * (nt + 1) // 2} tile pairs, and writes and reads partials of '
            f'{nt * 3 * n * 4 / 1e6:.3f} MB (K1) and {nt * 5 * n * 4 / 1e6:.3f} MB (K2) '
            f'({2 * nt * 8 * n * 4 / HBM_BPS * 1e3:.4f} ms at the HBM rate)')
        timed = (('fixed_field_and_scf_factors',
                  lambda: ED.fixed_field_and_scf_factors(sites, consts),
                  lambda: ED.fixed_field_and_scf_factors_plain(sites, consts)
                  if size == 'water256' else ED.fixed_field_and_scf_factors_tri_plain(sites,
                                                                                      consts)),
                 ('direct_energy_force_pot',
                  lambda: ED.direct_energy_force_pot(sites, mu, consts),
                  lambda: ED.direct_energy_force_pot_plain(sites, mu, consts)
                  if size == 'water256' else ED.direct_energy_force_pot_tri_plain(sites, mu,
                                                                                  consts)))
        for kname, kern, plain in timed:
            ms, plain_ms = time_kernel(torch, card, kname, kern, plain,
                                       N_TIMING if size == 'water256' else N_TIMING_TWIN_BS)
            rec = kernel_record(kname, max_abs[kname], ms, plain_ms, bounds[kname])
            if size == 'water256':
                record[kname] = rec
            log(f'  {size} {kname:28s} {ms:.4f} ms'
                + (f' (before the triangular form {DENSE_MS_BEFORE[kname]} ms)'
                   if size == 'water256' else '')
                + f', bound {bounds[kname][0]:.4f} ms ({bounds[kname][1]}), kernel / bound '
                f'{ms / bounds[kname][0]:.2f}, empty launch {floor:.4f} ms ({card})')
        del k1, tri1, tri1_64, k2, tri2, checks
        torch.cuda.empty_cache()
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
    assert sim.captured
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
        f'{cold_ms:.1f} ms) and the graph capture ({sim.capture_ms[0]:.1f} ms) ({card}); list '
        f'rebuilds {sim.list_rebuilds}')
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
        f'{pot._block_info["tile_pair_capacity"]}, s3/s5 line capacity '
        f'{pot._block_info["line_capacity"]}, pair/triplet/dispersion-pair caps '
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
    n_lines = block['line_capacity']
    checks = check.block_kernel_rows(sites, polarity, tiles, n, consts, n_lines)
    torch.cuda.synchronize()
    failures = []
    for kname, (rows, _) in checks.items():
        for row in rows:
            log(f'  {kname:28s} {row}')
            if not row.ok:
                failures.append(f'{kname}.{row.output}.{row.entries}.{row.measure}')

    field, lines = BS.fixed_field_and_scf_lines(sites, n, tiles, consts, n_lines)
    mu = (polarity[:, None] * field).contiguous()
    mu_pad = BS.pad_rows(mu, np_)
    torch.cuda.synchronize()
    pairs_act = n_act * BS.TILE * BS.TILE
    valid = (tiles.meta & BS.VALID) > 0
    stored = torch.arange(n_lines, device=lines.count.device) < lines.count[..., None]
    n_in = n_in_cutoff((lines.s3[stored], lines.s5[stored]))
    live = BS.live_lines(sites[:, :3], n, tiles, pot.pme.box, consts.cutoff)
    pairs_live = int(live.sum()) * BS.WATER * BS.CLUSTER
    n_stored = int(lines.count.sum())
    lists = cap * 12 + (n_tiles + 1) * 4
    rate = transcendental_rate()
    bounds = {
        'fixed_field_and_scf_lines': bound(np_ * 32 + lists + n * 12 + n_in * 8,
                                           n_in * (OPS_TEST + OPS_K1),
                                           n_transcendental=n_in * TRANS_K1,
                                           transcendental_rate=rate),
        'scf_dipole_field_bs': bound(np_ * 16 + np_ * 12 + lists + n_in * 8 + n * 12,
                                     n_in * OPS_K3),
        'direct_energy_force_pot_bs': bound(np_ * 32 + n * 12 + lists + n * 20,
                                            n_in * (OPS_TEST + OPS_K2),
                                            n_transcendental=n_in * TRANS_K2,
                                            transcendental_rate=rate)}
    log(f'  {n_in} in-cutoff ordered pairs of {pairs_act} in the active blocks '
        f'({n_in / pairs_act:.4%}); live (water, cluster) lines {int(live.sum())} of '
        f'{int(valid.sum()) * live.shape[1] * live.shape[2]} ({pairs_live / pairs_act:.4%} of '
        f'the candidates) by the twin\'s test, {n_stored} by K1-bs\'s')
    log(f'  s3/s5 lines: capacity {n_lines} per (row water, cluster) slab (the column tiles: '
        f'{n_tiles}); live lines per slab max {int(lines.count.max())}, mean '
        f'{float(lines.count.float().mean()):.2f}; overflow {bool(lines.overflow())}; '
        f'allocated {lines.nbytes() / 1e9:.4f} GB (whole blocks at this list capacity: '
        f'{2 * cap * BS.TILE * BS.TILE * 4 / 1e9:.4f} GB)')
    assert not bool(lines.overflow())
    log(f'  what the routes touch (bounds nothing): candidates of the active blocks '
        f'{pairs_act} (the cutoff test on all: {pairs_act * OPS_TEST / FP32_FLOPS * 1e3:.4f} ms '
        f'of operations), of the live lines {pairs_live} '
        f'({pairs_live * OPS_TEST / FP32_FLOPS * 1e3:.4f} ms); s3/s5 of the whole blocks '
        f'{2 * pairs_act * 4 / 1e9:.4f} GB ({2 * pairs_act * 4 / HBM_BPS * 1e3:.4f} ms), of the '
        f'live lines {2 * pairs_live * 4 / 1e9:.4f} GB ({2 * pairs_live * 4 / HBM_BPS * 1e3:.4f} '
        f'ms), of the in-cutoff pairs {2 * n_in * 4 / 1e9:.4f} GB')
    timed = (('fixed_field_and_scf_lines',
              lambda: BS.fixed_field_and_scf_lines(sites, n, tiles, consts, n_lines),
              lambda: BS.fixed_field_and_scf_lines_plain(sites, n, tiles, consts, n_lines)),
             ('scf_dipole_field_bs',
              lambda: BS.scf_dipole_field_bs(sites, lines, mu_pad, tiles, n, consts),
              lambda: BS.scf_dipole_field_bs_plain(sites, lines, mu_pad, tiles, n, consts)),
             ('direct_energy_force_pot_bs',
              lambda: BS.direct_energy_force_pot_bs(sites, mu, n, tiles, consts),
              lambda: BS.direct_energy_force_pot_bs_plain(sites, mu, n, tiles, consts)))
    for kname, kern, plain in timed:
        ms, plain_ms = time_kernel(torch, card, kname, kern, plain, N_TIMING_TWIN_BS)
        record[kname] = kernel_record(kname, checks[kname][1], ms, plain_ms, bounds[kname])
        log(f'  {kname:28s} {ms:.4f} ms (before the live-line layout {BS_MS_BEFORE[kname]} ms), '
            f'bound {bounds[kname][0]:.4f} ms ({bounds[kname][1]}), kernel / bound '
            f'{ms / bounds[kname][0]:.2f}')
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
    assert sim.captured
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
        f'the two converged evaluations step() makes at the chunk start and end and the graph '
        f'capture ({sim.capture_ms[0]:.1f} ms) ({card}); list rebuilds {sim.list_rebuilds}')
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
    mufu_rate = transcendental_rate()
    log(f'  transcendental unit: {MUFU_PER_CLOCK_PER_SM} results per clock per SM x {n_sms} SMs '
        f'x {mufu_rate / MUFU_PER_CLOCK_PER_SM / n_sms / 1e6:.0f} MHz (maximum SM clock) = '
        f'{mufu_rate / 1e12:.3f} T results/s')

    def n_bytes(tables):
        return sum(t.numel() * t.element_size() if torch.is_tensor(t) else t.nbytes
                   for t in tables)
    for poly, x in real.items():
        p, v = x.shape
        b, nmono = polyeval.load_quad(poly)[0].shape[0], polyeval.load_pip(poly).nmono
        io_bytes = 4 * p * (2 * v + 1)
        fp32_bound = bound(io_bytes + 4 * b * b, 2 * p * b * b + 2 * p * b * v)
        mono = PF.monomial_kernel_tables(poly)
        bounds = {'pip_energy_grad': bound(
            io_bytes + n_bytes((mono.c, mono.offsets, mono.ettiles)), p * nmono * OPS_MONO,
            n_transcendental=p * nmono, transcendental_rate=mufu_rate)}
        # what the kernel's route costs on top (information, not the bound)
        mono_route = (
            p * (nmono * OPS_MONO_SPLIT + len(mono.c) // MONO_TILE * (v + 1)) / FP32_FLOPS,
            MONO_PASSES * 2 * p * nmono * (v + 1) / BF16_TENSOR_FLOPS)
        tables = {'pip_quad_energy_grad': PF.quad_kernel_tables(poly),
                  'pip_quad_product_energy_grad': PF.quad_kernel_tables(poly),
                  'pip_vech_energy_grad': PF.vech_kernel_tables(poly)}
        for kname, elem in OPS_QUAD_ELEM.items():
            bounds[kname] = bound(io_bytes + n_bytes(tables[kname]), p * (b * elem + v),
                                  2 * p * b * (QUAD_PASSES * b + QUAD_GRAD_PASSES * v),
                                  f'bf16 x {QUAD_PASSES}')
        for wrapper in PF.KERNELS:
            kname = wrapper.__name__
            lib = library.get(wrapper, polyeval.pip_quad_energy_and_grad)
            ms, plain_ms = time_kernel(torch, card, kname, lambda: wrapper(poly, x),
                                       lambda: PF.PLAIN[wrapper](poly, x), N_TIMING_TWIN_BS)
            lib_ms = loop_ms(lambda: lib(x, poly), N_TIMING)
            log(f'  {kname:28s} {poly} [{p}, {v}]: bound {bounds[kname][0]:.4f} ms '
                f'({bounds[kname][1]}); {lib.__name__} on the same variables '
                f'{lib_ms:.4f} ms per call ({card})')
            if kname in OPS_QUAD_ELEM:
                blocks, waves = PF.launch_shape(p, n_sms)
                log(f'  {kname:28s} {poly} [{p}, {v}]: kernel {ms:.4f} ms, bound '
                    f'{bounds[kname][0]:.4f} ms (as plain fp32 operations it was '
                    f'{fp32_bound[0]:.4f} ms), twin {plain_ms:.4f} ms, library {lib_ms:.4f} ms, '
                    f'kernel / library {ms / lib_ms:.3f}, '
                    f'{2.0 * p * b * b / ms / 1e9:.1f} TFLOP/s effective (2 P B^2 over the '
                    f'kernel time), {blocks} blocks = {waves:.2f} waves of '
                    f'{PF.QUAD_BLOCKS_PER_SM} x {n_sms} ({card})')
            else:
                blocks, waves = PF.launch_shape(p, n_sms, PF.MONO_BLOCKS_PER_SM)
                rate = p * nmono / (ms * 1e-3)
                log(f'  {kname:28s} {poly} [{p}, {v}]: kernel {ms:.4f} ms, bound '
                    f'{bounds[kname][0]:.4f} ms (the route adds, outside the bound, '
                    f'{mono_route[0] * 1e3:.4f} ms of split and tile sums on the CUDA cores and '
                    f'{mono_route[1] * 1e3:.4f} ms of dense bf16 x {MONO_PASSES} passes), '
                    f'twin {plain_ms:.4f} ms, library {lib_ms:.4f} ms, '
                    f'kernel / library {ms / lib_ms:.3f}, {rate / 1e12:.3f} T monomials/s = '
                    f'{rate / mufu_rate:.1%} of the transcendental peak, {blocks} blocks = '
                    f'{waves:.2f} waves of {PF.MONO_BLOCKS_PER_SM} x {n_sms} ({card})')
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
        assert sim.captured
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


def same_capacities(src, dst):
    """dst takes src's list capacities, triplet-build shape and block layout
    (the analytic ones follow the construction box)."""
    from mbpol_openmm_plugin_tpu_torch.ops import neighbors
    cfg = src.config
    dst.pair_cap, dst.trip_cap = src.pair_cap, src.trip_cap
    dst.nlist_k_max = src.nlist_k_max or neighbors.max_neighbors(
        src.system.n_waters, src.system.box, cfg.cutoff_3b + cfg.nlist_skin)
    dst.nlist_kt = src.nlist_kt
    dst.disp_pair_cap = src.disp_pair_cap
    dst._block_info = src._block_info


def refuses_short_box(fn):
    """True when fn raises the wrappers' short-box ValueError."""
    try:
        fn()
    except ValueError as e:
        return 'twice the direct-space cutoff' in str(e)
    return False


def phase_dynamic_box(torch, card):
    """Phase 12: K1/K2 and the water256 evaluation at other boxes."""
    import dataclasses

    from mbpol_openmm_plugin_tpu_torch.md import integrators as I
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_check as check
    from mbpol_openmm_plugin_tpu_torch.tools.dense_probe import dense_inputs

    system, pos = load_water256(torch, torch.device('cuda'), torch.float32)
    sites, polarity, consts = dense_inputs((1, 1, 1))
    failures = []
    for scale in BOX_SCALES:
        sites_s = sites.clone()
        sites_s[:, :3] += I.molecule_centroid_shift(system, pos, scale)
        c = dataclasses.replace(consts, box=tuple(b * scale for b in consts.box))
        k1 = ED.fixed_field_and_scf_factors(sites_s, c)
        torch.cuda.synchronize()
        tri1 = ED.fixed_field_and_scf_factors_tri_plain(sites_s, c)
        tri1_64 = ED.fixed_field_and_scf_factors_tri_plain(sites_s.double(), c)
        mu = (polarity[:, None] * tri1[0]).contiguous()
        k2 = ED.direct_energy_force_pot(sites_s, mu, c)
        torch.cuda.synchronize()
        tri2 = ED.direct_energy_force_pot_tri_plain(sites_s, mu, c)
        for kname, rows in (('fixed_field_and_scf_factors',
                             check.k1_rows(sites_s, polarity, k1, tri1, tri1_64)),
                            ('direct_energy_force_pot', check.k2_rows(k2, tri2))):
            for row in rows:
                log(f'  box x {scale} ({c.box[0]:.5f} nm) {kname:28s} vs triangular {row}')
                if not row.ok:
                    failures.append(f'{scale}.{kname}.{row.output}.{row.entries}.{row.measure}')

    scale = BOX_SCALES[0]
    box = np.asarray(system.box) * scale
    pos_b = pos + I.molecule_centroid_shift(system, pos, scale)
    pot = MBPol(system, MBPolConfig(**SINGLE_POINT))
    fresh = MBPol(system.with_box(box), MBPolConfig(pme_grid=pot.pme.grid,
                                                    ewald_alpha=pot.pme.alpha, **SINGLE_POINT))
    same_capacities(pot, fresh)
    e_a, f_a, _, d_a = pot.energy_forces(pos_b, box=box)
    e_b, f_b, _, d_b = fresh.energy_forces(pos_b)
    e_rel = abs(float(e_a) - float(e_b)) / abs(float(e_b))
    f_rel = float((f_a - f_b).abs().max() / f_b.abs().max())
    log(f'  water256 at box x {scale}: E {float(e_a):.4f} kJ/mol, an MBPol built in that box '
        f'{float(e_b):.4f}: relative {e_rel:.3e}, forces max |dF| / max |F| {f_rel:.3e} (bound '
        f'{IDENTITY_REL}); SCF iterations {int(d_a["iterations"])} / {int(d_b["iterations"])}')
    assert bool(d_a['converged']) and bool(d_b['converged'])
    assert e_rel <= IDENTITY_REL and f_rel <= IDENTITY_REL, (e_rel, f_rel)

    short = dataclasses.replace(consts, box=(2.0 * consts.cutoff - 0.01,) * 3)
    refused = {
        'fixed_field_and_scf_factors': refuses_short_box(
            lambda: ED.fixed_field_and_scf_factors(sites, short)),
        'direct_energy_force_pot': refuses_short_box(
            lambda: ED.direct_energy_force_pot(sites, mu, short)),
        'MBPol.energy_forces': refuses_short_box(
            lambda: pot.energy_forces(pos, box=np.full(3, short.box[0])))}
    log(f'  a box of {short.box[0]:.2f} nm (cutoff {consts.cutoff} nm) refused by: {refused}')
    assert all(refused.values()), refused
    if failures:
        raise AssertionError(f'kernel/twin mismatch at a scaled box: {failures}')


def md_config(**kw):
    from mbpol_openmm_plugin_tpu_torch.md.simulation import SimulationConfig
    return SimulationConfig(dt=0.0002, nlist_rebuild_interval='auto', **kw)


def phase_nvt(torch, card):
    """Phase 13: water256 NVT, Langevin and Andersen."""
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED

    system, pos = load_water256(torch, torch.device('cuda'), torch.float32)
    pot = MBPol(system, MBPolConfig.for_dynamics())
    runs = (('langevin, friction 100/ps', dict(thermostat='langevin', friction=100.0),
             NVT_STEPS),
            ('andersen, 1000/ps', dict(thermostat='andersen', collision_frequency=1000.0),
             ANDERSEN_STEPS))
    rate = None
    for name, thermostat, steps in runs:
        sim = Simulation(pot, md_config(temperature=NVT_T_K, cm_motion_interval=1,
                                        **thermostat), seed=1)
        assert sim.captured
        sim.set_positions(pos)
        sim.set_velocities_to_temperature(NVT_T_K)
        torch.cuda.synchronize()
        ED.reset_launch_counts()
        t0 = time.perf_counter()
        out = sim.step(steps, report_interval=NVT_REPORT)   # raises on NaN, overflow, bad SCF
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in ED.KERNELS}
        t = out['step_temperature']
        mean_t = float(np.mean(t[steps // 2:]))
        log(f'  {name}: {steps} steps in reports of {NVT_REPORT}, {wall:.3f} s = '
            f'{steps / wall:.2f} steps/s ({card}); T after step 1 {t[0]:.2f} K, mean T over '
            f'steps {steps // 2 + 1}..{steps} {mean_t:.3f} K (gate {NVT_T_K} +/- {NVT_T_TOL_K}), T_end {t[-1]:.2f} K; '
            f'launches {launches}')
        if NVT_REFERENCE is not None and steps == NVT_STEPS:
            log(f'  the JAX reference (tools/md_ensemble_reference.py, f32, CPU, reports of '
                f'{NVT_REPORT}): {NVT_REFERENCE}')
        assert np.all(np.isfinite(out['step_total_energy'])), out
        assert all(n >= steps for n in launches.values()), launches
        assert abs(mean_t - NVT_T_K) <= NVT_T_TOL_K, mean_t
        rate = rate or steps / wall
    return rate


def npt_simulation(pot, pos, interval, seed):
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation
    sim = Simulation(pot, md_config(temperature=NVT_T_K, thermostat='langevin', friction=1.0,
                                    barostat_pressure=1.0, barostat_interval=interval),
                     seed=seed)
    assert sim.captured
    sim.set_positions(pos)
    sim.set_velocities_to_temperature(NVT_T_K)
    return sim


def run_npt(torch, card, sim, steps, interval, kernels):
    """steps NPT steps as reports of one barostat group each; after each
    accepted move the state's energy against a fresh converged evaluation.
    Returns (attempted, accepted, relative volume change, steps/s, the
    largest energy difference, launches)."""
    v0 = float(np.prod(sim.state.box))
    for k in kernels:
        k.launches = 0
    attempted = accepted = 0
    wall = 0.0
    e_rel = []
    for _ in range(steps // interval):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sim.step(interval)       # raises on NaN, overflow (a trial's too), bad SCF
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        assert np.all(np.isfinite(out['step_total_energy'])), out
        attempted += out['barostat_attempted']
        accepted += out['barostat_accepted']
        if out['barostat_accepted']:
            fresh = float(sim.potential.energy_forces(sim.state.positions,
                                                      box=sim.state.box)[0])
            e_rel.append(abs(float(sim.state.potential_energy) - fresh) / abs(fresh))
    launches = {k.__name__: k.launches for k in kernels}
    dv = float(np.prod(sim.state.box)) / v0 - 1.0
    log(f'  {steps} steps in {wall:.3f} s = {steps / wall:.3f} steps/s, the moves and the '
        f'health checks included ({card}); moves attempted {attempted}, accepted {accepted}; '
        f'box {sim.state.box[0]:.5f} nm, dV/V {dv:+.4%}; move scale '
        f'{sim._baro[0]:.5f} nm^3; accepted moves\' energy vs a fresh evaluation: max relative '
        f'{max(e_rel, default=0.0):.3e} (bound {NPT_E_REL}); launches {launches}')
    captures = sim.capture_ms
    log(f'  graph captures: {len(captures)} (the first box and each box a move moved to '
        f'before a group), {np.mean(captures):.1f} ms each on the mean (min '
        f'{np.min(captures):.1f}, max {np.max(captures):.1f}), {np.sum(captures) / 1e3:.3f} s '
        f'of the {wall:.3f} s')
    assert attempted == steps // interval, attempted
    assert all(r <= NPT_E_REL for r in e_rel), e_rel
    assert all(n >= steps for n in launches.values()), launches
    return attempted, accepted, dv, steps / wall


def phase_npt(torch, card):
    """Phase 14: water256 NPT, a checkpointed resume, L-BFGS."""
    import tempfile

    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED

    system, pos = load_water256(torch, torch.device('cuda'), torch.float32)
    pot = MBPol(system, MBPolConfig.for_dynamics())
    sim = npt_simulation(pot, pos, NPT_INTERVAL, seed=2)
    attempted, accepted, dv, rate = run_npt(torch, card, sim, NPT_STEPS, NPT_INTERVAL,
                                            ED.KERNELS)
    assert accepted >= 1, accepted
    assert abs(dv) < NPT_DV_MAX, dv

    half = CHECKPOINT_STEPS // 2
    a = npt_simulation(pot, pos, NPT_INTERVAL, seed=3)
    a.step(CHECKPOINT_STEPS, report_interval=half)
    b = npt_simulation(pot, pos, NPT_INTERVAL, seed=3)
    b.step(half)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'npt.npz')
        b.save_checkpoint(path)
        c = Simulation(pot, b.config, seed=0)
        c.load_checkpoint_file(path)
    c.step(half)
    same = {name: bool(torch.equal(getattr(a.state, name), getattr(c.state, name)))
            for name in ('positions', 'velocities', 'forces', 'potential_energy')}
    same['box'] = bool(np.array_equal(a.state.box, c.state.box))
    same['barostat'] = a._baro == c._baro
    same['generator'] = bool(torch.equal(a.generator.get_state(), c.generator.get_state()))
    log(f'  {CHECKPOINT_STEPS} steps against {half} + checkpoint file + new Simulation + {half}: '
        f'bit-identical {same}; box {a.state.box[0]:.6f} / {c.state.box[0]:.6f} nm')
    assert all(same.values()), same

    sim = Simulation(MBPol(system, MBPolConfig(**SINGLE_POINT)), SimulationConfig())
    sim.set_positions(pos)
    rms0 = float(torch.sqrt(torch.sum(sim.state.forces ** 2) / system.n_atoms))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    diag = sim.minimize_energy(max_iterations=MINIMIZE_ITERATIONS, tolerance=1.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rms1 = float(torch.sqrt(torch.sum(sim.state.forces ** 2) / system.n_atoms))
    energies = diag['energies']
    rises = sum(b > a for a, b in zip(energies, energies[1:]))
    log(f'  L-BFGS: {diag["iterations"]} iterations in {wall:.2f} s ({card}); E '
        f'{energies[0]:.4f} -> {energies[-1]:.4f} kJ/mol, rises {rises}; RMS force '
        f'{rms0:.3f} -> {rms1:.3f} kJ/mol/nm')
    assert diag['iterations'] == MINIMIZE_ITERATIONS and rises == 0, diag
    assert rms1 < rms0, (rms0, rms1)
    return rate, attempted, accepted


def phase_npt4096(torch, card):
    """Phase 15: water4096 NPT in block + pairs mode."""
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as BS
    pot, pos = water4096_potential(torch, card)
    sim = npt_simulation(pot, pos, NPT4096_INTERVAL, seed=5)
    return run_npt(torch, card, sim, NPT4096_STEPS, NPT4096_INTERVAL, BS.KERNELS)


# phases 16-18: the cluster (NoCutoff) path and r-RESPA
FIXTURES = os.path.join(REPO, 'tests', 'fixtures')
CLUSTER_SP = dict(nonbonded_method='NoCutoff', cutoff=0.9)
WATER3_GOLDEN_KCAL, WATER3_ELEC_KCAL, WATER3_TOL_KCAL = -8.78893485, -15.818784, 0.1
THREE_SITE_KCAL, THREE_SITE_TOL_KCAL = -7.08652, 0.01
# the JAX package's own float32-vs-float64 distance on each input, both at
# the float32 positions (tools/cluster_respa_reference.py --what single, JAX
# on the CPU; PERF.md):
# per term |dE| (kJ/mol), forces max |dF| / max |F|, the moments max |d| /
# max |m|, the potential on the grid max |d| (kJ/mol/e); the water256 PME
# electrostatics at phase 4's settings. Phase 16 holds the card's float32
# against the port's CPU float64 at F32_BOUND_FACTOR times these.
JAX_F32_DISTANCE = {
    'water14_cluster': dict(
        terms=dict(dispersion=1.2159039584958009e-05, electrostatics=0.038762184642223474,
                   one_body=0.00032163309650456995, three_body=0.07852130841933302,
                   two_body=0.2878866384492085),
        forces_rel=0.0007183364460706797),
    'water256_droplet': dict(
        terms=dict(dispersion=9.929993666446535e-05, electrostatics=0.791519930042341,
                   one_body=0.0012241374617080192, three_body=3.2520305983723574,
                   two_body=6.905955647955125),
        forces_rel=0.002558965595714546, moments_rel=4.91024924880731e-05,
        grid_abs=0.003527610733161879),
    'water256_pme': dict(terms=dict(electrostatics=0.07032796453677292))}
F32_BOUND_FACTOR = 2.0
# DIIS against SOR: both converged to DIIS_EPS (scf_eps_floor lowered to it),
# beyond the closures' own stopping error at the single point's 1e-4
DIIS_EPS = 1e-6
GRID_RADIUS, N_GRID = 2.0, 64
WATER14_MD = dict(nonbonded_method='NoCutoff', target_epsilon=1e-3, max_iterations=200,
                  restraint_radius=0.75, restraint_k=1000.0)      # bench.py:566-568
WATER14_STEPS, WATER14_T_K, WATER14_FRICTION = 500, 300.0, 1.0
DROPLET_STEPS = 200
# 3 x the largest |second-half fit| of the JAX float32 readings of the same
# runs (tools/cluster_respa_reference.py --what droplet_md respa_md; PERF.md)
DROPLET_FIT_READINGS = (0.2154590071270634, 0.47362854679359917, 0.2704368595773131)
RESPA_FIT_READINGS = (3.3912033150054817, 4.633115190184036, -0.009621460518840027)
RESPA_A_STEPS, RESPA_B_STEPS, RESPA_C_STEPS = 100, 50, 200
RESPA_T_K, RESPA_FRICTION, RESPA_REPORT = 300.0, 100.0, 10


def fit_bound(readings):
    return 3.0 * max(abs(r) for r in readings)


def load_positions(torch, name, system, box=None):
    """A fixture's positions, whole in `box` and with the M sites placed in
    float64 on the CPU, then on the card in float32."""
    from mbpol_openmm_plugin_tpu_torch.system import compute_virtual_sites, make_molecules_whole
    with np.load(os.path.join(FIXTURES, name + '.npz')) as z:
        pos = torch.as_tensor(np.array(z['positions'], np.float64))
    if box is not None:
        pos = make_molecules_whole(system.with_box(box), pos)
    pos = compute_virtual_sites(system, pos)
    return pos.to(device='cuda', dtype=torch.float32)


def cluster_system(name):
    from mbpol_openmm_plugin_tpu_torch.system import System
    with np.load(os.path.join(FIXTURES, name + '.npz')) as z:
        return System.from_atom_names(z['names'], z['resnames'])


def cluster_input(torch, name):
    """(System without a box, card float32 positions, the same positions in
    float64 on the CPU) of a cluster: the water14 cluster, or the water256
    droplet (the water256 fixture made whole in its box, evaluated without
    one)."""
    if name == 'water256_droplet':
        system = cluster_system('water256_integration_test')
        box = [BOX] * 3
        src = 'water256_integration_test'
    else:
        system, box, src = cluster_system(name), None, name
    pos = load_positions(torch, src, system, box)
    return system, pos, pos.cpu().double()


def three_site_params(elec):
    """The 3-site water3 of tests/test_electrostatics_cluster.py."""
    damping = np.tile([0.001310, 0.000294, 0.000294], 3)
    return elec.ElecParams(
        thole=np.full(5, 0.4), damping=damping, polarity=damping.copy(),
        mol_index=np.repeat(np.arange(3), 3), atom_type=np.tile([0, 1, 1], 3),
        charges=np.tile([-5.1966000e-01, 2.5983000e-01, 2.5983000e-01], 3),
        include_charge_redistribution=False, target_epsilon=1e-9)


THREE_SITE_POS_A = np.array([
    [-1.516074336, -0.202316765, 1.454672917], [-0.6218989773, -0.6009430735, 1.572437625],
    [-2.017613812, -0.4190350349, 2.239642849], [-1.763651687, -0.3816594649, -1.300353949],
    [-1.903851736, -0.4935677617, -0.3457810126], [-2.527904158, -0.7613550077, -1.733803676],
    [-0.558847214, 2.006699172, -0.1392786582], [-0.941155818, 1.541226676, 0.6163293071],
    [-0.9858551734, 1.567124294, -0.8830970941]])


def within(name, got, bound, failures):
    """Log got against bound; a failure is recorded, not raised."""
    ok = got <= bound
    log(f'    {name}: {got:.4e} (bound {bound:.4e}, {"ok" if ok else "FAIL"})')
    if not ok:
        failures.append(name)


def phase_cluster_single_points(torch, card):
    """Phase 16: the cluster path's single points, float32 on the card."""
    import dataclasses

    from mbpol_openmm_plugin_tpu_torch.models import electrostatics as elec
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.ops import pip_fused as PF
    from mbpol_openmm_plugin_tpu_torch.system import oxygen_positions
    from mbpol_openmm_plugin_tpu_torch.utils import units

    kcal = units.KJ_PER_MOL_TO_KCAL_PER_MOL
    failures = []
    # goldens
    sys3, pos3, _ = cluster_input(torch, 'water3')
    e, f, parts, diag = MBPol(sys3, MBPolConfig(**CLUSTER_SP)).energy_forces(pos3)
    e_el, _, d_el = elec.cluster_electrostatics(elec.ElecParams.for_system(sys3), pos3)
    log(f'  water3: total {float(e) * kcal:.6f} kcal/mol (golden {WATER3_GOLDEN_KCAL} +/- '
        f'{WATER3_TOL_KCAL}); 4-site electrostatics {float(e_el) * kcal:.6f} (golden '
        f'{WATER3_ELEC_KCAL} +/- {WATER3_TOL_KCAL}); SOR iterations {int(diag["iterations"])}')
    assert bool(diag['converged']) and bool(d_el['converged'])
    assert abs(float(e) * kcal - WATER3_GOLDEN_KCAL) <= WATER3_TOL_KCAL, float(e) * kcal
    assert abs(float(e_el) * kcal - WATER3_ELEC_KCAL) <= WATER3_TOL_KCAL, float(e_el) * kcal
    pos9 = torch.as_tensor(THREE_SITE_POS_A * 0.1, dtype=torch.float32, device='cuda')
    iters = {}
    for method in ('sor', 'diis'):
        params = dataclasses.replace(three_site_params(elec), scf_method=method)
        e9, _, d9 = elec.cluster_electrostatics(params, pos9)
        iters[method] = int(d9['iterations'])
        log(f'  3-site water3 under {method}: {float(e9) * kcal:.6f} kcal/mol (golden '
            f'{THREE_SITE_KCAL} +/- {THREE_SITE_TOL_KCAL}), {iters[method]} iterations')
        assert bool(d9['converged'])
        assert abs(float(e9) * kcal - THREE_SITE_KCAL) <= THREE_SITE_TOL_KCAL, float(e9) * kcal
    assert iters['diis'] < iters['sor'], iters

    # water14 cluster and water256 droplet against the port's CPU float64
    for name in ('water14_cluster', 'water256_droplet'):
        system, pos, pos64 = cluster_input(torch, name)
        ref = MBPol(system, MBPolConfig(**CLUSTER_SP), device='cpu').tune_capacities(pos64)
        t0 = time.perf_counter()
        e64, f64, p64, d64 = ref.energy_forces(pos64)
        log(f'  {name}: {system.n_waters} waters, {pos.shape[0]} sites; CPU float64 reference '
            f'{float(e64) * kcal:.4f} kcal/mol ({int(d64["iterations"])} SOR iterations, '
            f'{time.perf_counter() - t0:.1f} s)')
        dist = JAX_F32_DISTANCE[name]
        for impl in (None, 'quad_bf16'):
            pot = MBPol(system, MBPolConfig(pip_impl=impl, **CLUSTER_SP)).tune_capacities(pos)
            PF.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e32, f32, p32, d32 = pot.energy_forces(pos)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k.__name__: k.launches for k in PF.KERNELS}
            log(f'  {name} pip_impl={impl!r}: {float(e32) * kcal:.4f} kcal/mol, SOR iterations '
                f'{int(d32["iterations"])}, {wall * 1e3:.1f} ms ({card}); lists '
                f'{pot.use_neighbor_lists} (pair/triplet capacities '
                f'{getattr(pot, "pair_cap", None)}/{getattr(pot, "trip_cap", None)}); '
                f'launches {launches}')
            assert bool(d32['converged']) and bool(torch.isfinite(f32).all())
            assert not any(bool(v) for k, v in d32.items() if k.endswith('_overflow')), d32
            if impl == 'quad_bf16':
                assert launches['pip_quad_product_energy_grad'] == 2, launches
            for term, d in dist['terms'].items():
                within(f'{name} {impl or "default"} {term} |dE| kJ/mol',
                       abs(float(p32[term]) - float(p64[term])), F32_BOUND_FACTOR * d, failures)
            within(f'{name} {impl or "default"} forces max |dF| / max |F|',
                   float((f32.cpu().double() - f64).abs().max() / f64.abs().max()),
                   F32_BOUND_FACTOR * dist['forces_rel'], failures)

    # moments and the potential on a grid about the droplet
    system, pos, pos64 = cluster_input(torch, 'water256_droplet')
    params = elec.ElecParams.for_system(system)
    center = oxygen_positions(system, pos64).mean(dim=0).numpy()
    k = np.arange(N_GRID) + 0.5
    phi, theta = np.arccos(1.0 - 2.0 * k / N_GRID), np.pi * (1.0 + 5 ** 0.5) * k
    grid = center + GRID_RADIUS * np.stack([np.cos(theta) * np.sin(phi),
                                            np.sin(theta) * np.sin(phi), np.cos(phi)], axis=1)
    m32 = elec.system_moments(params, pos, system.masses).cpu().double()
    m64 = elec.system_moments(params, pos64, system.masses)
    grid = torch.as_tensor(grid, dtype=torch.float32)
    g32 = elec.electrostatic_potential_on_grid(params, pos, grid.cuda()).cpu().double()
    g64 = elec.electrostatic_potential_on_grid(params, pos64, grid.double())
    dist = JAX_F32_DISTANCE['water256_droplet']
    log(f'  water256 droplet: dipole {m64[1:4].tolist()} D; potential on {N_GRID} points at '
        f'{GRID_RADIUS} nm, max |phi| {float(g64.abs().max()):.4f} kJ/mol/e')
    within('droplet moments max |d| / max |m|', float((m32 - m64).abs().max() / m64.abs().max()),
           F32_BOUND_FACTOR * dist['moments_rel'], failures)
    within('droplet grid potential max |d| kJ/mol/e', float((g32 - g64).abs().max()),
           F32_BOUND_FACTOR * dist['grid_abs'], failures)

    # DIIS against SOR at the droplet and at the water256 PME single point
    sys256, pos256 = load_water256(torch, torch.device('cuda'), torch.float32)
    tight = dict(target_epsilon=DIIS_EPS, scf_eps_floor=DIIS_EPS, terms=('electrostatics',))
    for name, system_, pos_, cfg in (
            ('water256_droplet', system, pos, dict(CLUSTER_SP, **tight)),
            ('water256_pme', sys256, pos256, dict(SINGLE_POINT, **tight))):
        out = {}
        for method in ('sor', 'diis'):
            pot = MBPol(system_, MBPolConfig(scf_method=method, **cfg))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e, _, _, d = pot.energy_forces(pos_)
            torch.cuda.synchronize()
            out[method] = (float(e), int(d['iterations']), bool(d['converged']),
                           time.perf_counter() - t0)
        (e_s, it_s, c_s, w_s), (e_d, it_d, c_d, w_d) = out['sor'], out['diis']
        log(f'  {name} at eps {DIIS_EPS}: electrostatics SOR {e_s:.4f} ({it_s} iterations, '
            f'{w_s * 1e3:.1f} ms), DIIS {e_d:.4f} kJ/mol ({it_d} iterations, {w_d * 1e3:.1f} '
            f'ms) ({card})')
        assert c_s and c_d and it_d < it_s, out
        within(f'{name} DIIS - SOR electrostatics |dE| kJ/mol', abs(e_d - e_s),
               F32_BOUND_FACTOR * JAX_F32_DISTANCE[name]['terms']['electrostatics'], failures)
    if failures:
        raise AssertionError(f'cluster single points outside their bounds: {failures}')


def respa_launches(ED, steps):
    launches = {k.__name__: k.launches for k in ED.KERNELS}
    return launches, {k: round(v / steps, 2) for k, v in launches.items()}


def phase_cluster_md(torch, card):
    """Phase 17: cluster MD, the water14 cluster under the restraint
    (Langevin) and the water256 droplet (NVE)."""
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig

    system, pos, _ = cluster_input(torch, 'water14_cluster')
    sim = Simulation(MBPol(system, MBPolConfig(**WATER14_MD)),
                     SimulationConfig(dt=0.0002, temperature=WATER14_T_K, thermostat='langevin',
                                      friction=WATER14_FRICTION), seed=1)
    sim.set_positions(pos)
    sim.set_velocities_to_temperature(WATER14_T_K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sim.step(WATER14_STEPS, report_interval=100)   # raises on NaN or a failed SCF
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t = out['step_temperature']
    e_r = float(sim.potential.energy_forces(sim.state.positions)[2]['restraint'])
    log(f'  water14 cluster, restraint R {WATER14_MD["restraint_radius"]} nm, Langevin '
        f'{WATER14_T_K} K at {WATER14_FRICTION}/ps: {WATER14_STEPS} steps in {wall:.2f} s = '
        f'{WATER14_STEPS / wall:.2f} steps/s ({card}); mean T over steps '
        f'{WATER14_STEPS // 2 + 1}..{WATER14_STEPS} {float(np.mean(t[WATER14_STEPS // 2:])):.2f} '
        f'K (reported, not gated: 42 atoms); restraint energy at the end {e_r:.4f} kJ/mol')
    assert np.all(np.isfinite(out['step_total_energy'])), out

    system, pos, _ = cluster_input(torch, 'water256_droplet')
    pot = MBPol(system, MBPolConfig.for_dynamics(nonbonded_method='NoCutoff'))
    pot.tune_capacities(pos)
    sim = Simulation(pot, SimulationConfig(dt=0.0002, nlist_rebuild_interval='auto'))
    sim.set_positions(pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sim.step(DROPLET_STEPS)     # raises on NaN, list overflow or a failed SCF
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    e_tot = out['step_total_energy']
    fit = second_half_fit(e_tot)
    bound = fit_bound(DROPLET_FIT_READINGS)
    log(f'  water256 droplet NVE (for_dynamics, NoCutoff, ASPC): {DROPLET_STEPS} steps in '
        f'{wall:.2f} s = {DROPLET_STEPS / wall:.2f} steps/s ({card}); E_tot {e_tot[0]:.4f} -> '
        f'{e_tot[-1]:.4f} kJ/mol, second-half fit {fit:+.4f} kJ/mol (bound {bound:.4f} = 3 x the '
        f'largest JAX reading of {DROPLET_FIT_READINGS}); T_end {out["temperature"][-1]:.2f} K')
    assert np.all(np.isfinite(e_tot)), out
    assert abs(fit) <= bound, fit
    return DROPLET_STEPS / wall


def respa_simulation(torch, pot, pos, temperature=None, **scfg):
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
    sim = Simulation(pot, SimulationConfig(nlist_rebuild_interval=scfg.pop('interval', 'auto'),
                                           temperature=temperature, **scfg), seed=1)
    sim.set_positions(pos)
    if temperature is not None:
        sim.set_velocities_to_temperature(temperature)
    return sim


CAPTURE_STEPS = {256: MD_STEPS, 4096: 50}


@contextlib.contextmanager
def sync_checked_replays(torch):
    """Every step of Simulation's groups under
    torch.cuda.set_sync_debug_mode('error') (a synchronizing call raises),
    except a graph's warm-up and capture (torch.cuda.graph synchronizes
    the device on entry)."""
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation
    from mbpol_openmm_plugin_tpu_torch.md.step_graph import StepGraph
    group, capture = Simulation._group, StepGraph._warm_up_and_capture

    def strict_group(self, *a):
        torch.cuda.set_sync_debug_mode('error')
        try:
            return group(self, *a)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def lenient_capture(self, body):
        torch.cuda.set_sync_debug_mode(0)
        try:
            capture(self, body)
        finally:
            torch.cuda.set_sync_debug_mode('error')
    Simulation._group, StepGraph._warm_up_and_capture = strict_group, lenient_capture
    try:
        yield
    finally:
        Simulation._group, StepGraph._warm_up_and_capture = group, capture


def phase_captured_step(torch, card):
    """Phase 19: the same steps eager and captured from the same state,
    water256 (dense) and water4096 (block + pairs): E_tot traces equal bit
    for bit, the captured groups free of synchronizing calls, the rates."""
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig

    probe = torch.ones(1, device='cuda')
    torch.cuda.set_sync_debug_mode('error')
    try:
        probe.item()
        raise AssertionError("set_sync_debug_mode('error') let .item() through")
    except RuntimeError:
        pass
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rows = {}
    for waters, steps in CAPTURE_STEPS.items():
        if waters == 256:
            system, pos = load_water256(torch, torch.device('cuda'), torch.float32)
            pot = MBPol(system, MBPolConfig.for_dynamics())
        else:
            pot, pos = water4096_potential(torch, card)

        def run(eager, checked=False):
            sim = Simulation(pot, md_config(), _eager=eager)
            assert sim.captured == (not eager), sim.captured
            sim.set_positions(pos)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if checked:
                with sync_checked_replays(torch):
                    out = sim.step(steps)
            else:
                out = sim.step(steps)
            torch.cuda.synchronize()
            return sim, out, time.perf_counter() - t0

        sim_e, out_e, wall_e = run(True)
        sim_c, out_c, wall_c = run(False, checked=True)
        same = (np.array_equal(out_e['step_total_energy'], out_c['step_total_energy'])
                and bool(torch.equal(sim_e.state.positions, sim_c.state.positions))
                and bool(torch.equal(sim_e.state.velocities, sim_c.state.velocities)))
        # the other order, for the rates
        _, _, wall_c2 = run(False)
        _, _, wall_e2 = run(True)
        ms_e = 1e3 * (wall_e + wall_e2) / (2 * steps)
        ms_c = 1e3 * (wall_c + wall_c2) / (2 * steps)
        log(f'  water{waters} ({pot.elec_mode}/{pot.disp_mode}), {steps} steps from the same '
            f'state: E_tot traces and final state equal bit for bit: {same}; the captured groups '
            f"ran under set_sync_debug_mode('error'); graph capture {sim_c.capture_ms[0]:.1f} ms; "
            f'list rebuilds {sim_c.list_rebuilds}')
        log(f'    wall per step (the call, its converged seed and health check included; '
            f'two runs each, eager / captured / captured / eager): eager {1e3 * wall_e / steps:.3f}'
            f' / {1e3 * wall_e2 / steps:.3f} ms, captured {1e3 * wall_c / steps:.3f} / '
            f'{1e3 * wall_c2 / steps:.3f} ms; {1e3 / ms_e:.2f} -> {1e3 / ms_c:.2f} steps/s, '
            f'speedup {ms_e / ms_c:.2f}x ({card})')
        assert same, (out_e['step_total_energy'][-3:], out_c['step_total_energy'][-3:])
        assert np.all(np.isfinite(out_c['step_total_energy'])), out_c
        rows[waters] = (1e3 / ms_e, 1e3 / ms_c)
        del pot, sim_e, sim_c
        torch.cuda.empty_cache()
    return rows


def phase_respa(torch, card, base_rate):
    """Phase 18: r-RESPA on water256 PME (for_dynamics), K1/K2 on every rung
    that holds the electrostatics."""
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED

    system, pos = load_water256(torch, torch.device('cuda'), torch.float32)
    pot = MBPol(system, MBPolConfig.for_dynamics())
    runs = (('(a) two-level, inner 2, outer 0.4 fs, NVE',
             dict(dt=0.0004, respa_inner=2), RESPA_A_STEPS, None),
            ("(b) three-level 'mid', mid 2, inner 2, outer 0.8 fs, list interval 2, NVE",
             dict(dt=0.0008, respa_mid=2, respa_inner=2, interval=2), RESPA_B_STEPS, None),
            ("(b) three-level 'inner', mid 2, inner 2, outer 0.8 fs, list interval 2, NVE",
             dict(dt=0.0008, respa_mid=2, respa_inner=2, interval=2,
                  respa_polarization_rung='inner'), RESPA_B_STEPS, None),
            (f'(c) two-level Langevin {RESPA_T_K} K at {RESPA_FRICTION}/ps, inner 2, outer '
             f'0.4 fs', dict(dt=0.0004, respa_inner=2, thermostat='langevin',
                             friction=RESPA_FRICTION), RESPA_C_STEPS, RESPA_T_K))
    for name, scfg, steps, temperature in runs:
        base_steps = scfg.get('respa_mid', 1) * scfg['respa_inner']
        sim = respa_simulation(torch, pot, pos, temperature, **scfg)
        torch.cuda.synchronize()
        ED.reset_launch_counts()
        t0 = time.perf_counter()
        out = sim.step(steps, report_interval=RESPA_REPORT if temperature else None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, per_step = respa_launches(ED, steps)
        e_tot = out['step_total_energy']
        fit = second_half_fit(e_tot)
        log(f'  {name}: {steps} outer steps in {wall:.2f} s = {steps / wall:.2f} outer steps/s '
            f'= {base_steps * steps / wall:.2f} base-step (0.2 fs) equivalents/s (phase 5, '
            f'single step: {base_rate:.2f} steps/s) ({card}); K1/K2 launches {launches} = '
            f'{per_step} per outer step; E_tot {e_tot[0]:.4f} -> {e_tot[-1]:.4f} kJ/mol, '
            f'second-half fit {fit:+.4f} kJ/mol; T_end {out["temperature"][-1]:.2f} K')
        assert np.all(np.isfinite(e_tot)), out
        assert all(n >= steps for n in launches.values()), launches
        if temperature is None and base_steps == scfg['respa_inner']:
            bound = fit_bound(RESPA_FIT_READINGS)
            log(f'    gate: |fit| <= {bound:.4f} kJ/mol (3 x the largest JAX reading of '
                f'{RESPA_FIT_READINGS})')
            assert abs(fit) <= bound, fit
        if temperature is not None:
            t = out['step_temperature']
            mean_t = float(np.mean(t[steps // 2:]))
            log(f'    mean T over outer steps {steps // 2 + 1}..{steps} {mean_t:.3f} K (gate '
                f'{temperature} +/- {NVT_T_TOL_K})')
            assert abs(mean_t - temperature) <= NVT_T_TOL_K, mean_t


# phases 20-23: path-integral MD, the virial pressure and replica exchange
PIMD_DT, PIMD_TAU0, PIMD_NL_EVERY, PIMD_SPREAD = 1e-4, 0.1, 25, 0.002
PIMD_BEADS, PIMD_BEADS_REF = 8, 24
PIMD_WINDOW, PIMD_THERM = 100, 1000
PIMD_DRIFT_KJ = 400.0
PIMD_KE_RATIO_MIN, PIMD_KE_8_24 = 1.3, (0.55, 1.05)
# phase 21: the JAX float32 fits of the ring-polymer Hamiltonian over the
# second half of the same 200-step protocol, seeds 0 / 1 / 2
# (tools/pimd_remd_reference.py --what hamiltonian)
HAM_STEPS, HAM_EAGER_STEPS = 200, 20
HAM_FIT_READINGS = (7.261843877400007, 6.975443178519774, 5.860730926040125)
# phase 22: NPT-PIMD on phase 14's protocol, and the pressure
PIMD_NPT_STEPS, PIMD_NPT_INTERVAL, PIMD_CHECKPOINT_STEPS = 500, 25, 100
# |P32 - P64| of the JAX virial_pressure at the water256 fixture, 300 K,
# and its float64 reading (tools/pimd_remd_reference.py --what pressure), bar
PRESSURE_JAX_F32_DISTANCE = 121.83339758963484
PRESSURE_JAX_F64_BAR = 10775.311913214635
# the port's CPU float64 dU/dlambda against the JAX float64 jvp, relative
# (tests/test_torch_pressure.py's bound)
PRESSURE_F64_REL = 1e-6
PIMD_PRESSURE_STEPS, PIMD_PRESSURE_REPORT = 20, 10
# phase 23: REMD, thermalization + timed blocks, cut from bench.py's 4 + 4
# (water256) and 40 + 40 (water14) to keep the script within half its time
# limit
REMD_BLOCKS = {'water256': (2, 4), 'water14': (2, 4)}


def pimd_potential(torch):
    """The water256 potential of bench.py's PIMD figure:
    for_dynamics(scf_method='sor') after tune_capacities(margin=1.3)."""
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    system, pos = load_water256(torch, torch.device('cuda'), torch.float32)
    pot = MBPol(system, MBPolConfig.for_dynamics(scf_method='sor'))
    pot.tune_capacities(pos, margin=1.3)
    return pot, pos


def k12_launches():
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
    return sum(k.launches for k in ED.KERNELS) / len(ED.KERNELS)


def phase_pimd(torch, card, classical_rate):
    """Phase 20: contracted PIMD (8 -> 1 and 24 -> 1) at water256, bench.py's
    protocol and physics gates."""
    from mbpol_openmm_plugin_tpu_torch.md.rpmd import PIMDSimulation
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
    from mbpol_openmm_plugin_tpu_torch.utils import units

    pot, pos = pimd_potential(torch)
    n_real = int(np.sum(np.asarray(pot.system.masses) > 0))
    classical_ke = 1.5 * n_real * units.BOLTZMANN_KJ_MOL_K * 300.0
    ke, rate = {}, None
    for nb in (PIMD_BEADS, PIMD_BEADS_REF):
        sim = PIMDSimulation(pot, n_beads=nb, dt=PIMD_DT, temperature=300.0, tau0=PIMD_TAU0,
                             contraction=1, seed=0, nlist_rebuild_interval=PIMD_NL_EVERY)
        assert sim.captured
        sim.set_positions(pos, spread=PIMD_SPREAD)
        t0 = time.perf_counter()
        sim.step(PIMD_THERM, report_interval=PIMD_WINDOW)      # health-checked
        torch.cuda.synchronize()
        therm = time.perf_counter() - t0
        m0 = sim.step(PIMD_WINDOW, check_health=False)
        torch.cuda.synchronize()
        ED.reset_launch_counts()
        t0 = time.perf_counter()
        m = sim.step(PIMD_WINDOW, check_health=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        per_step = k12_launches() / PIMD_WINDOW
        sim.step(2, report_interval=2)                          # the health gate
        ke_cv = float(np.mean(m['step_kinetic_virial']))
        drift = float(m['total_energy'][-1] - m0['total_energy'][-1])
        finite = all(np.all(np.isfinite(x[k])) for x in (m0, m)
                     for k in ('step_potential_energy', 'step_kinetic_virial'))
        ke[nb] = ke_cv
        log(f'  {nb} beads contracted to 1, list interval {PIMD_NL_EVERY}: {PIMD_THERM} '
            f'thermalization steps in {therm:.2f} s (reports of {PIMD_WINDOW}, health-checked); '
            f'timed window {PIMD_WINDOW} steps in {wall:.3f} s = {PIMD_WINDOW / wall:.2f} steps/s '
            f'({card}); K1/K2 launches per step {per_step:.2f}; graph captures '
            f'{len(sim.capture_ms)} ({np.mean(sim.capture_ms):.1f} ms)')
        log(f'    KE_cv (window mean) {ke_cv:.2f} kJ/mol = {ke_cv / classical_ke:.3f} x the '
            f'classical 3/2 N kT (gate > {PIMD_KE_RATIO_MIN}; ceiling {nb} x); window drift of '
            f'E_tot {drift:+.2f} kJ/mol (gate |.| < {PIMD_DRIFT_KJ}); finite {finite}')
        assert finite, (m0, m)
        assert 0.0 < ke_cv < classical_ke * nb, ke_cv
        assert ke_cv / classical_ke > PIMD_KE_RATIO_MIN, ke_cv
        assert abs(drift) < PIMD_DRIFT_KJ, drift
        assert abs(per_step - 1.0) < 0.05, per_step
        rate = rate or PIMD_WINDOW / wall
        del sim
    ratio = ke[PIMD_BEADS] / ke[PIMD_BEADS_REF]
    log(f'  KE_cv({PIMD_BEADS}) / KE_cv({PIMD_BEADS_REF}) = {ratio:.3f} (gate in '
        f'{PIMD_KE_8_24}); contracted PIMD {rate:.2f} steps/s against the classical '
        f'{classical_rate:.2f} (phase 5): {classical_rate / rate:.3f} x the classical per-step '
        f'time ({card})')
    assert PIMD_KE_8_24[0] < ratio < PIMD_KE_8_24[1], ratio
    return rate


def phase_hamiltonian_rpmd(torch, card):
    """Phase 21: Hamiltonian RPMD (thermostat 'none') with 8 full beads at
    water256: the fit of the ring-polymer Hamiltonian, the launches per
    step, and the captured step against the eager one bit for bit."""
    from mbpol_openmm_plugin_tpu_torch.md.rpmd import PIMDSimulation, ring_polymer_hamiltonian
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED

    pot, pos = pimd_potential(torch)

    def sim_for(eager=False):
        sim = PIMDSimulation(pot, n_beads=PIMD_BEADS, dt=PIMD_DT, temperature=300.0,
                             thermostat='none', seed=0, nlist_rebuild_interval=PIMD_NL_EVERY,
                             _eager=eager)
        assert sim.captured == (not eager)
        sim.set_positions(pos, spread=PIMD_SPREAD)
        return sim

    sim = sim_for()
    h0 = float(ring_polymer_hamiltonian(sim.system, sim.state, 300.0))
    torch.cuda.synchronize()
    ED.reset_launch_counts()
    t0 = time.perf_counter()
    out = sim.step(HAM_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_step = k12_launches() / HAM_STEPS
    h = np.concatenate([[h0], out['step_hamiltonian']])
    fit = second_half_fit(h)
    bound = None if HAM_FIT_READINGS is None else fit_bound(HAM_FIT_READINGS)
    log(f'  8 full beads, thermostat none, list interval {PIMD_NL_EVERY}: {HAM_STEPS} steps in '
        f'{wall:.3f} s = {HAM_STEPS / wall:.2f} steps/s ({card}); K1/K2 launches per step '
        f'{per_step:.3f}; graph capture {sim.capture_ms[0]:.1f} ms')
    log(f'    H {h[0]:.4f} / {h[HAM_STEPS // 2]:.4f} / {h[-1]:.4f} kJ/mol; second-half fit '
        f'{fit:+.4f} kJ/mol (bound {bound} = 3 x the largest JAX float32 reading of '
        f'{HAM_FIT_READINGS})')
    assert np.all(np.isfinite(h)), h
    assert bound is not None and abs(fit) <= bound, (fit, bound)
    # one evaluation per bead and step, and the health check's one
    assert abs(per_step - (PIMD_BEADS + 1.0 / HAM_STEPS)) < 0.05, per_step
    del sim
    runs = {}
    for eager in (True, False):
        s2 = sim_for(eager)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = s2.step(HAM_EAGER_STEPS)
        torch.cuda.synchronize()
        runs[eager] = (s2, o, time.perf_counter() - t0)
    (se, oe, we), (sc, oc, wc) = runs[True], runs[False]
    same = (np.array_equal(oe['step_hamiltonian'], oc['step_hamiltonian'])
            and all(bool(torch.equal(getattr(se.state, k), getattr(sc.state, k)))
                    for k in ('positions', 'velocities', 'forces', 'potential_energy')))
    log(f'  {HAM_EAGER_STEPS} steps eager and captured from the same state: H traces and final '
        f'state equal bit for bit: {same}; eager {HAM_EAGER_STEPS / we:.2f} steps/s, captured '
        f'{HAM_EAGER_STEPS / wc:.2f} (the capture included) ({card})')
    assert same, (oe['step_hamiltonian'][-3:], oc['step_hamiltonian'][-3:])
    return HAM_STEPS / wall


def phase_pimd_npt(torch, card):
    """Phase 22: NPT-PIMD (8 -> 1, PILE, 1 bar, a move every 25 steps), a
    checkpointed resume, the virial pressure against the JAX float64, and
    the ring-polymer pressure of a short uncontracted run."""
    import tempfile

    from mbpol_openmm_plugin_tpu_torch.md import pressure as PR
    from mbpol_openmm_plugin_tpu_torch.md.rpmd import PIMDSimulation
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol
    from mbpol_openmm_plugin_tpu_torch.system import compute_virtual_sites, make_molecules_whole
    from mbpol_openmm_plugin_tpu_torch.utils import units

    pot, pos = pimd_potential(torch)

    def npt(seed):
        sim = PIMDSimulation(pot, n_beads=PIMD_BEADS, dt=PIMD_DT, temperature=300.0,
                             tau0=PIMD_TAU0, contraction=1, seed=seed, barostat_pressure=1.0,
                             barostat_interval=PIMD_NPT_INTERVAL)
        assert sim.captured
        sim.set_positions(pos, spread=PIMD_SPREAD)
        return sim

    sim = npt(2)
    v0 = float(np.prod(sim.state.box))
    attempted = accepted = 0
    e_rel, f_abs, wall = [], [], 0.0
    launches0 = k12_launches()
    for _ in range(PIMD_NPT_STEPS // PIMD_NPT_INTERVAL):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sim.step(PIMD_NPT_INTERVAL)      # raises on NaN, overflow (trials too), bad SCF
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        assert np.all(np.isfinite(out['step_potential_energy'])), out
        attempted += out['barostat_attempted']
        accepted += out['barostat_accepted']
        if out['barostat_accepted']:
            e, f, _ = sim._converged(sim.state.positions, sim.state.box)
            e_rel.append(float(torch.max(torch.abs(sim.state.potential_energy - e))
                               / torch.max(torch.abs(e))))
            f_abs.append(float(torch.max(torch.abs(sim.state.forces - f))))
    per_step = (k12_launches() - launches0) / PIMD_NPT_STEPS
    dv = float(np.prod(sim.state.box)) / v0 - 1.0
    log(f'  {PIMD_NPT_STEPS} steps in {wall:.3f} s = {PIMD_NPT_STEPS / wall:.2f} steps/s, the '
        f'moves and health checks included ({card}); moves attempted {attempted}, accepted '
        f'{accepted}; box {sim.state.box[0]:.5f} nm, dV/V {dv:+.4%}; K1/K2 launches per step '
        f'{per_step:.2f}; graph captures {len(sim.capture_ms)} ({np.sum(sim.capture_ms) / 1e3:.3f}'
        f' s)')
    log(f'    accepted moves against a fresh converged evaluation at their positions and box: '
        f'per-bead energies max relative {max(e_rel, default=0.0):.3e} (bound {NPT_E_REL}), '
        f'forces max |dF| {max(f_abs, default=0.0):.3e} kJ/mol/nm (the JAX function keeps the '
        f'old forces)')
    assert attempted == PIMD_NPT_STEPS // PIMD_NPT_INTERVAL and accepted >= 1, attempted
    assert abs(dv) < NPT_DV_MAX, dv
    assert all(r <= NPT_E_REL for r in e_rel), e_rel
    assert all(d <= NPT_E_REL * 1e3 for d in f_abs), f_abs
    del sim

    half = PIMD_CHECKPOINT_STEPS // 2
    a = npt(3)
    a.step(PIMD_CHECKPOINT_STEPS, report_interval=half)
    b = npt(3)
    b.step(half)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'pimd.npz')
        b.save_checkpoint(path)
        c = PIMDSimulation(pot, n_beads=PIMD_BEADS, dt=PIMD_DT, temperature=300.0,
                           tau0=PIMD_TAU0, contraction=1, seed=0, barostat_pressure=1.0,
                           barostat_interval=PIMD_NPT_INTERVAL)
        c.load_checkpoint_file(path)
    c.step(half)
    same = {k: bool(torch.equal(getattr(a.state, k), getattr(c.state, k)))
            for k in ('positions', 'velocities', 'forces', 'potential_energy')}
    same['box'] = bool(np.array_equal(a.state.box, c.state.box))
    same['barostat'] = a._baro == c._baro
    same['generator'] = bool(torch.equal(a.generator.get_state(), c.generator.get_state()))
    same['dipoles'] = bool(torch.equal(a._mu, c._mu))
    log(f'  {PIMD_CHECKPOINT_STEPS} steps against {half} + checkpoint file + new PIMDSimulation '
        f'+ {half}: bit-identical {same}')
    assert all(same.values()), same
    del a, b, c

    # the virial pressure at the fixture: the card (float32) and the port's
    # CPU float64 against the JAX float64 jvp, at the tool's positions (the
    # fixture rounded to float32, then whole, M sites placed in float64)
    sys_ = pot.system
    ref = MBPol(sys_, pot.config, device='cpu')
    with np.load(FIXTURE) as z:
        raw = torch.as_tensor(np.asarray(z['positions'], np.float32)).double()
    pos64 = compute_virtual_sites(sys_, make_molecules_whole(sys_, raw))
    ref.tune_capacities(pos64)
    vol_bar = 3 * float(np.prod(sys_.box)) * PR.BAR_IN_KJ_MOL_NM3
    t0 = time.perf_counter()
    p64 = PR.virial_pressure(ref, pos64, temperature_k=300.0)
    t64 = time.perf_counter() - t0
    t0 = time.perf_counter()
    p32 = PR.virial_pressure(pot, pos64.to(pos), temperature_k=300.0)
    torch.cuda.synchronize()
    t32 = time.perf_counter() - t0
    ideal = 3 * sys_.n_waters * units.BOLTZMANN_KJ_MOL_K * 300.0
    du64 = ideal - p64 * vol_bar
    bound64 = PRESSURE_F64_REL * abs(du64) / vol_bar
    bound32 = F32_BOUND_FACTOR * PRESSURE_JAX_F32_DISTANCE
    log(f'  virial_pressure at the water256 fixture, 300 K (dU/dlambda by autograd with the '
        f'dipoles held): CPU float64 {p64:.4f} bar ({t64:.1f} s), the JAX float64 jvp '
        f'{PRESSURE_JAX_F64_BAR:.4f}: |d| {abs(p64 - PRESSURE_JAX_F64_BAR):.4f} bar (bound '
        f'{bound64:.4f} = {PRESSURE_F64_REL:g} of |dU/dlambda| {abs(du64):.4f} kJ/mol)')
    log(f'  card float32 {p32:.4f} bar ({t32:.2f} s): against the JAX float64 |d| '
        f'{abs(p32 - PRESSURE_JAX_F64_BAR):.4f} bar (bound {bound32:.2f} = 2 x the JAX float32 '
        f'distance {PRESSURE_JAX_F32_DISTANCE:.2f}), against the CPU float64 '
        f'{abs(p32 - p64):.4f} ({card})')
    assert abs(p64 - PRESSURE_JAX_F64_BAR) <= bound64, (p64, PRESSURE_JAX_F64_BAR)
    assert abs(p32 - PRESSURE_JAX_F64_BAR) <= bound32, (p32, PRESSURE_JAX_F64_BAR)

    sim = PIMDSimulation(pot, n_beads=PIMD_BEADS, dt=PIMD_DT, temperature=300.0, tau0=PIMD_TAU0,
                         seed=4)
    sim.set_positions(pos, spread=PIMD_SPREAD)
    t0 = time.perf_counter()
    out = sim.step(PIMD_PRESSURE_STEPS, report_interval=PIMD_PRESSURE_REPORT,
                   report_pressure=True)
    wall = time.perf_counter() - t0
    log(f'  8 full beads, PILE, {PIMD_PRESSURE_STEPS} steps with report_pressure every '
        f'{PIMD_PRESSURE_REPORT}: rpmd_virial_pressure {np.round(out["pressure"], 2).tolist()} '
        f'bar, mean {float(np.mean(out["pressure"])):.2f} (not gated) in {wall:.2f} s ({card})')
    assert np.all(np.isfinite(out['pressure'])), out


def check_permutations(walkers, accepts, start_walker, parity0):
    """Each block's walkers follow a valid even/odd sweep: an involution of
    neighbour swaps on the block's parity, accepted exactly where the
    sweep says. Returns the number of swaps."""
    prev, swaps = np.asarray(start_walker), 0
    for b, (w, acc) in enumerate(zip(walkers, accepts)):
        R = len(w)
        perm = np.array([int(np.nonzero(prev == w[i])[0][0]) for i in range(R)])
        assert np.array_equal(perm[perm], np.arange(R)), (b, perm)
        for i in range(R):
            d = perm[i] - i
            assert d in (-1, 0, 1), (b, perm)
            if d == 1:
                assert i % 2 == (parity0 + b) % 2 and acc[i], (b, perm, acc)
                swaps += 1
            elif d == 0:
                assert not acc[i], (b, perm, acc)
        prev = np.asarray(w)
    return swaps


def run_ladder(torch, card, name, pot, pos, temperatures, config, blocks, checkpoint=False):
    """Thermalization and timed blocks of one ladder, each block its own
    health-checked run() call. Returns (replica-steps/s, acceptance, K1/K2
    launches per step)."""
    from mbpol_openmm_plugin_tpu_torch.md import remd
    sim = remd.REMDSimulation(pot, temperatures, config, seed=0)
    sim.set_positions(pos)
    sim.set_velocities_to_temperature()
    R, k = len(temperatures), config.exchange_interval
    n_therm, n_timed = blocks
    walkers, accepts, wall, parity0 = [], [], 0.0, 0
    start = sim.walker.copy()
    launches0 = k12_launches()
    for b in range(n_therm + n_timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sim.run(1)        # raises on a list overflow, NaN or an unhealthy replica
        torch.cuda.synchronize()
        if b >= n_therm:
            wall += time.perf_counter() - t0
        assert np.all(np.isfinite(out['potential_energy'])), out
        walkers.append(out['walker'][0])
        accepts.append(out['accept'][0])
    per_step = (k12_launches() - launches0) / ((n_therm + n_timed) * k)
    swaps = check_permutations(walkers, accepts, start, parity0)
    rate = n_timed * k * R / wall
    log(f'  {name}, R = {R} ({np.round(temperatures, 1).tolist()} K): {n_therm} + {n_timed} '
        f'blocks of {k} steps, each block health-checked; timed {n_timed * k} steps in '
        f'{wall:.2f} s = {rate:.2f} replica-steps/s ({card}); acceptance per pair '
        f'{np.round(out["acceptance"], 3).tolist()}, swaps {swaps}, walkers {walkers[-1].tolist()}'
        f'; K1/K2 launches per step {per_step:.2f}')
    if checkpoint:
        ck = sim.checkpoint()
        ref = sim.run(1)
        sim2 = remd.REMDSimulation(pot, temperatures, config, seed=9)
        sim2.load_checkpoint(ck)
        again = sim2.run(1)
        same = (np.array_equal(ref['potential_energy'], again['potential_energy'])
                and np.array_equal(ref['walker'], again['walker'])
                and bool(torch.equal(sim.state.positions, sim2.state.positions))
                and bool(torch.equal(sim.state.velocities, sim2.state.velocities)))
        log(f'    one block after a checkpoint against the uninterrupted ladder: bit-identical '
            f'{same}')
        assert same
    return rate, out['acceptance'], per_step


def phase_remd(torch, card):
    """Phase 23: REMD, (a) water256 R = 2 (bench.py:481-533), (b) the water14
    cluster at R = 1 and R = 8 (bench.py:535-630); eager (SOR)."""
    from mbpol_openmm_plugin_tpu_torch.md import remd
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig

    system, pos = load_water256(torch, torch.device('cuda'), torch.float32)
    pot = MBPol(system, MBPolConfig.for_dynamics(scf_method='sor', nlist_skin=0.03))
    pot.tune_capacities(pos)
    cfg = remd.REMDConfig(dt=2e-4, exchange_interval=25, nlist_reuse=True)
    rates = {}
    for R in (1, 2):
        rates[R], _, per_step = run_ladder(torch, card, 'water256 PME, SOR warm start', pot, pos,
                                           remd.geometric_ladder(290.0, 330.0, R), cfg,
                                           REMD_BLOCKS['water256'])
        assert abs(per_step - R) < 0.2 * R, per_step
    log(f'  water256 ladder efficiency (R = 2 rate / (2 x the R = 1 rate)) '
        f'{rates[2] / (2 * rates[1]):.3f} ({card})')
    del pot
    system, pos, _ = cluster_input(torch, 'water14_cluster')
    pot = MBPol(system, MBPolConfig(**WATER14_MD))
    cfg = remd.REMDConfig(dt=2e-4, exchange_interval=25)
    for R in (1, 8):
        rates[R], _, _ = run_ladder(torch, card, 'water14 cluster, restraint 0.75 nm', pot, pos,
                                    remd.geometric_ladder(180.0, 480.0, R), cfg,
                                    REMD_BLOCKS['water14'], checkpoint=R == 8)
    log(f'  water14 ladder efficiency (R = 8 rate / (8 x the R = 1 rate)) '
        f'{rates[8] / (8 * rates[1]):.3f} ({card})')


_PHASE = {}


def begin_phase(title):
    """Log the wall time of the phase before and the header of the next."""
    now = time.perf_counter()
    if _PHASE:
        log(f'  ({_PHASE["name"]} wall {now - _PHASE["t0"]:.1f} s)')
    if title is not None:
        log(title)
        _PHASE.update(name=title.split(':')[0].strip('= '), t0=now)


def main():
    import torch
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device visible (torch.cuda.is_available() is false)',
              file=sys.stderr)
        return 2
    import mbpol_openmm_plugin_tpu_torch  # noqa: F401  (precision switches)
    from mbpol_openmm_plugin_tpu_torch.ops import _build

    begin_phase('== phase 1: card')
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f'  {card}')
    log(f'  torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, '
        f'count {torch.cuda.device_count()}')
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == 'highest'

    begin_phase('== phase 2: kernel build')
    t0 = time.perf_counter()
    path = _build.build()
    log(f'  built {os.path.relpath(path, REPO)} in {time.perf_counter() - t0:.2f} s')
    for line in _build.build_log().splitlines():
        if any(w in line for w in ('registers', 'spill', 'Compiling', 'arning')):
            log('  ' + line.strip())

    record = {}
    begin_phase('== phase 3: dense kernels vs twins (water256 and water2048, float32)')
    phase_kernels(torch, card, record)
    begin_phase('== phase 4: single point (water256 PME, float32)')
    pot256, e256, f256, parts256 = phase_single_point(torch, card)
    begin_phase(f'== phase 5: MD (water256, for_dynamics, {MD_STEPS} Verlet steps at 0.2 fs)')
    quad_steps_per_s = phase_md(torch, card, record)
    begin_phase('== phase 6: block kernels vs twins (water4096, float32)')
    pot4096, pos4096 = water4096_potential(torch, card)
    phase_block_kernels(torch, card, record, pot4096, pos4096)
    begin_phase('== phase 7: replication (water4096 single point vs water256 x 2 x 2 x 4)')
    phase_replication(torch, card, pot256, e256, f256)
    begin_phase(f'== phase 8: MD (water4096, for_dynamics, block/pairs, {MD4096_STEPS} Verlet steps '
        f'at 0.2 fs)')
    torch.cuda.reset_peak_memory_stats()
    phase_md4096(torch, card, record, pot4096, pos4096)
    del pot4096, pos4096
    torch.cuda.empty_cache()
    begin_phase('== phase 9: fused PIP kernels vs twins (water256 lists and seeded rows, float32)')
    phase_pip_kernels(torch, card, record)
    begin_phase('== phase 10: single point under each fused pip_impl (water256 PME, float32)')
    phase_pip_single_point(torch, card, e256, f256, parts256)
    begin_phase(f'== phase 11: MD under each fused pip_impl (water256, for_dynamics; {MD_STEPS} Verlet '
        f"steps under 'quad_bf16', {PIP_MD_STEPS_SHORT} under the others)")
    phase_pip_md(torch, card, record, quad_steps_per_s)
    begin_phase('== phase 12: dynamic box (K1/K2 and water256 at 1.01 and 0.99 x the box)')
    phase_dynamic_box(torch, card)
    begin_phase(f'== phase 13: NVT (water256, for_dynamics; Langevin {NVT_STEPS} steps, Andersen '
        f'{ANDERSEN_STEPS})')
    nvt_rate = phase_nvt(torch, card)
    begin_phase(f'== phase 14: NPT (water256, for_dynamics, Langevin, 1 bar, {NPT_STEPS} steps, '
        f'barostat_interval {NPT_INTERVAL}); checkpoint; L-BFGS')
    npt_rate, _, _ = phase_npt(torch, card)
    begin_phase(f'== phase 15: NPT (water4096, block/pairs, {NPT4096_STEPS} steps, barostat_interval '
        f'{NPT4096_INTERVAL})')
    phase_npt4096(torch, card)
    log(f'  water256 steps/s: NVE {quad_steps_per_s:.2f} (phase 5), NVT {nvt_rate:.2f}, '
        f'NPT {npt_rate:.2f} ({card})')
    begin_phase('== phase 16: cluster single points (water3 goldens, water14 cluster, water256 droplet; '
        'float32 against CPU float64)')
    phase_cluster_single_points(torch, card)
    begin_phase(f'== phase 17: cluster MD (water14 + restraint, Langevin {WATER14_STEPS} steps; water256 '
        f'droplet NVE {DROPLET_STEPS} steps)')
    phase_cluster_md(torch, card)
    begin_phase('== phase 18: r-RESPA (water256 PME, for_dynamics)')
    phase_respa(torch, card, quad_steps_per_s)
    begin_phase(f'== phase 19: captured step against the eager step (water256 {CAPTURE_STEPS[256]} '
        f'steps, water4096 {CAPTURE_STEPS[4096]})')
    phase_captured_step(torch, card)
    begin_phase(f'== phase 20: PIMD (water256, 8 -> 1 and 24 -> 1 contracted, PILE, '
                f'{PIMD_THERM} + {PIMD_WINDOW} steps)')
    pimd_rate = phase_pimd(torch, card, quad_steps_per_s)
    begin_phase(f'== phase 21: Hamiltonian RPMD (water256, 8 full beads, {HAM_STEPS} steps)')
    full_rate = phase_hamiltonian_rpmd(torch, card)
    begin_phase(f'== phase 22: NPT-PIMD (water256, 8 -> 1, 1 bar, {PIMD_NPT_STEPS} steps, '
                f'barostat_interval {PIMD_NPT_INTERVAL}); checkpoint; virial pressure')
    phase_pimd_npt(torch, card)
    begin_phase('== phase 23: REMD (water256 R = 1, 2; water14 cluster R = 1, 8)')
    phase_remd(torch, card)
    begin_phase(None)
    log(f'  steps/s: classical {quad_steps_per_s:.2f} (phase 5), PIMD contracted {pimd_rate:.2f},'
        f' 8 full beads {full_rate:.2f} ({card})')
    log(f'  chip_smoke wall {time.perf_counter() - t_script:.1f} s')

    log(card)
    log(json.dumps({'kernels': [record[k] for k in KERNELS]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
