#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (mbpol_openmm_plugin_tpu_torch).

Drives the port's paths on one CUDA card, in float32, through the entry
points a user calls (MBPol, tune_capacities, energy_forces, Simulation,
PIMDSimulation, REMDSimulation, virial_pressure, the builder and app layer,
the per-force API):
MB-pol water256 bulk PME in the dense electrostatics mode, water4096 (the
water256 fixture repeated 2 x 2 x 4, 16,384 sites) in the block-sparse
mode that 'auto' picks above 2560 waters on a card, water256 again with
the 2B/3B polynomials evaluated by each fused kernel
(MBPolConfig.pip_impl), the cluster (NoCutoff) path on water clusters up
to 256 waters, r-RESPA on water256 PME, path-integral MD (contracted,
full-bead and NPT), replica exchange, the app layer (every example INI
rendered by the port's builder and run, and the per-force API), and the
large-box path: the sparse electrostatics at water4096, list compaction,
the reference triplets, water8192 through the capacity planner and the
site-chunked PME grid, and the compensated drift tool; and the device
mesh (parallel/mesh.py) with four shards on the one card. It
builds the hand-written CUDA kernels from csrc/ and holds each against its
plain PyTorch twin at the shapes its path gives it.

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
 24. the app layer and the builder: every example INI (examples/
     mbpol_config.ini and examples/example_ini/*.ini) rendered by the port's
     builder (no --platform: the card) and run in-process in a temporary
     directory, K1/K2 counted, on PDBs written from tests/fixtures/ by the
     port's writer; the steps of the RESPA, PIMD and REMD INIs cut
     (APP_RUNS, each cut logged). (a) the water256 bulk single point
     (mbpol_bulk_energy.ini): the printed energy and the NetCDF forces
     against the same INI rendered with --platform CPU (the port's float64)
     within F32_BOUND_FACTOR x the JAX app's own float32 distance
     (tools/app_reference.py); (b) NVE, NVT and NPT captured, their logs'
     rows on the report grid and finite, trajectories written; 100 more app
     steps of the NVE script timed beside phase 5's rate, with the share of
     the report edges' converged evaluations; (c) NPT barostat moves
     attempted, the pressure column finite; (d) the water14 NetCDF file in
     AMBER conventions, minimization lowers the energy; (e) the PIMD and
     REMD branches run (energies finite, acceptance per pair); (f) the
     per-force API's PME electrostatics on the water256 fixture against
     MBPol's term (API_REL), with_updated_params(thole) bit for bit a fresh
     MBPol and back. K1/K2 launch in every bulk run and in (f).
 25. sparse electrostatics (the water-pair list mode, plain PyTorch): (a)
     the water256 single point in 'sparse' against phase 4's dense one,
     each term, the total and max |dF| / max |F| within F32_BOUND_FACTOR x
     the JAX package's own float32 sparse-vs-dense distance
     (SPARSE_JAX_F32, tools/large_n_reference.py); (b) water4096 sparse
     after tune_capacities (PME grid x 2 x 2 x 4) against the water256
     sparse single point x 16 under phase 7's bounds, with its peak device
     memory; (c) 20 captured water4096 NVE steps under
     for_dynamics(electrostatics_mode='sparse'): finite, healthy, no pair
     overflow; steps/s beside phase 8's block rate;
 26. list compaction and the reference triplets at water256 dense: single
     points under compact_eval True and 'rebuild', with the default 'quad'
     and with 'quad_bf16' (kernel #10 on the compacted batches), each term,
     the total and the forces against the uncompacted evaluation within
     F32_BOUND_FACTOR x the JAX float32 compacted-vs-plain distance
     (COMPACT_JAX_F32); kernel #10 against its twin on the compacted 2B/3B
     variables and its time; the rows kept; ms per captured step without
     compaction, with True and with 'rebuild' (200 'rebuild' steps from
     rest under phase 5's conservation gate); triplet_semantics='reference':
     the triplet count equal to the port's CPU float64 count at the same
     positions, the three-body energy within F32_BOUND_FACTOR x the JAX
     float32-vs-float64 distance (REFERENCE_3B_JAX_F32) of the CPU float64
     one;
 27. water8192 (the fixture x 2 x 4 x 4, 32,768 sites, block mode):
     plan_capacities from the positions (native counts; its caps equal to
     the port's torch counts on the card, as integers), MBPol(plan=plan)
     with the PME grid x 2 x 4 x 4; the chunk sizes of the spread and the
     read-back; K1-bs, K3-bs and K2-bs against their twins at this size
     and their device times; the single point against water256 x 32 under
     phase 7's bounds; the spread and read-back unchunked against chunked
     (CHUNK_REL of max) with both peaks of memory; the plan's
     mem_per_device_mb beside torch.cuda.max_memory_allocated; 20 captured
     NVE steps under for_dynamics through a plan: finite, healthy, no
     tile, line, pair or triplet overflow, the block kernels every step;
     steps/s;
 28. compensated accumulation: the port's drift tool
     (tools/nve_drift.py) on water256, for_dynamics, 2000 steps plain and
     --kahan from Maxwell-Boltzmann velocities at 300 K: each arm's fitted
     drift over 100 steps finite and within phase 5's bound; both fits and
     both rates printed.
 29. the device mesh: make_mesh(devices=[cuda:0] x 4) (torch.cuda.device_count()
     printed). (a) the full-grid row kernels #3/#4 (fixed_field_rows_kernel,
     direct_efp_rows_kernel: rows own blocks and walk their columns, one
     launch each) shard by shard against their twins at water256 (1024
     sites), water2048 (8192) and water4096 dense (16,384; the twins on shard
     0 and the last shard), on the entry sets of ops/elec_direct_check.py
     (at water4096 the block sets' per-entry bound, with the float32 twin's
     own distance printed), two launches on the same inputs bit for bit, and
     over all rows against K1/K2 (triangular); ms per launch of one shard's
     rows beside the bound, the twin, K1/K2, the earlier design's ms, one
     CUDA graph replay of the calls and the empty-launch floor;
     (b) water256 dense, 4 shards, against the unmeshed single point, SCF at
     DIIS_EPS on both sides: electrostatics within F32_BOUND_FACTOR x the JAX
     float32 distance, the other terms TERM_REL, forces REPLICA_F_WHOLE; under
     'quad_bf16' the 2B/3B energies compared bit for bit (why not, printed);
     (c) water4096 block, 4 shards of 16 row tiles: each shard's K1-bs/K3-bs/
     K2-bs against their twins on its local list, the per-shard tile pairs,
     no overflow, the single point against the unmeshed block one (bits
     printed); (d) 200 captured water256 NVE steps meshed under phase 5's
     gate, the row kernels 4 times a step (their launch counts in the
     summary), steps/s beside phase 5's, 10 steps eager against captured
     bit for bit; (e) water4096 sparse and water8192
     block through plan_capacities(n_devices=4) against one-device plans'
     single points under the replication rows, the per-device fields; (f) 8
     full beads over the 4 shards, 10 captured steps, and the water14 REMD
     ladder R = 8 over them, one block of 3 steps, each bit for bit the
     unmeshed run: each shard's beads or slots run through its own copy of
     the potential (MBPol.to_device), so on one card (f) checks
     the copies and the bead/slot routing, not a transfer between cards.
     With more than one card visible, (b) also over distinct cards.
 30. the example applications (mbpol_openmm_plugin_tpu_torch/examples/ and
     the tools bulk_validation and respa_drift), each called in-process
     through the function its main() calls, health checks on, with the
     kernel launch counts set to 0 before and read after each (a kernel of
     its path launched no time fails): make_inputs (PDBs into a temp dir),
     water14 (app single point, 20 minimizer iterations, 100 NVE steps),
     example_nvt_nve (10 + 100 NVT, 100 NVE app steps); bulk_properties 400
     (400 Langevin + 400 NVE steps, 20 frames): every observable finite,
     g_OO's first peak in 0.265-0.290 nm and 2.4-3.6 high (the bands of
     tools/bulk_validation.py), S(q), H-bonds, q_tet, D, epsilon printed,
     and the report edges' share of the production (the same steps again as
     one chunk); ir_spectrum 100 (200 + 100 steps, water14 cluster): the
     band peaks and the edges' share; isotope_density 100 --beads 8
     --interval 25: finite densities, moves attempted for both isotopes,
     the ratio printed; water256_pimd 20 and water14_pimd 8 10: steps/s
     and KE_virial against 3/2 NkT, and water14_pimd's eager step under
     torch.profiler (device-busy time, kernels, host reads; not gated);
     remd_water14 2 blocks and no warm-up block (the script's 2), R = 4,
     without and with --mesh (4 shards of cuda:0): MBAR finite; water2048_scaling
     2048 dense,block,sparse: converged, no overflow, each mode's single
     point within REPLICA_E_REL (energy) and REPLICA_F_WHOLE (forces) of the
     dense one; multichip_scaling 2048 4 (4 shards of cuda:0): no overflow,
     converged, the Verlet loop finite; bulk_validation --npt-eq-ps 0
     --npt-ps 0.5 --nve-ps 0.2: the g_OO bands gated, the density and D
     printed with every verdict; respa_drift, one short arm (EXAMPLE_RESPA).
     Depths are cut only as listed here (PERF.md section 4).
Each phase prints its wall time and the script its total.
Phases 5, 8, 11, 13-15, 17, 20-22, 24's NVE, NVT and NPT runs, 25-28's MD, 29 (d), (f) and 30's
Simulation and PIMDSimulation runs each step
as a replay of one CUDA graph (Simulation.captured, PIMDSimulation.captured;
the kernel wrappers' launch counts include the replays); phases 18
(r-RESPA) and 23 (REMD) run eagerly, as do 30's functional ring-polymer loops,
REMD, RESPA and scaling loops (converged evaluations).
The last two lines are a JSON summary of the kernels and
{"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py     (needs one CUDA card; no arguments)
"""
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np

from mbpol_openmm_plugin_tpu_torch.tools.dense_probe import (OPS_K1, OPS_K2, OPS_TEST, TRANS_K1,
                                                           TRANS_K2, dense_bounds)
from mbpol_openmm_plugin_tpu_torch.tools.timing import (BF16_TENSOR_FLOPS, FP32_FLOPS, HBM_BPS,
                                                        MUFU_PER_CLOCK_PER_SM, bound, card_line,
                                                        graph_ms, kernel_device_ms, loop_ms,
                                                        median_ms, transcendental_rate)
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
PROFILER_TRIES = 3
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
# phase 29 (a): the row kernels also at water4096 dense (16,384 sites, the
# dense limit's size for 4 shards, models/potential.py), where the twin rows
# run on shard 0 and the last shard only, with the per-entry bound of the
# block kernels' water4096 sets (ops/elec_direct_check.py ELEM_BS: the same
# sites; the float32 twin itself reads 3.3e-5 on s5 there); and their
# device ms per launch of one shard in the earlier tile-pair design (PERF.md
# section 6, rows 3-4), logged beside this run's
MESH_DENSE_REPS = dict(DENSE_REPS, water4096=(2, 2, 4))
TWIN_ENDS_ONLY = ('water4096',)
ROW_MS_BEFORE = {'fixed_field_and_scf_factors_rows': {'water256': '0.0074-0.0076',
                                                      'water2048': '0.0737-0.0743'},
                 'direct_energy_force_pot_rows': {'water256': '0.0077-0.0084',
                                                  'water2048': '0.0730-0.0736'}}
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
    'fixed_field_and_scf_factors_rows': (
        'fixed_field_rows_kernel', SOURCE, 'mbpol_openmm_plugin_tpu/ops/elec_pallas.py:179'),
    'direct_energy_force_pot_rows': (
        'direct_efp_rows_kernel', SOURCE, 'mbpol_openmm_plugin_tpu/ops/elec_pallas.py:213'),
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


def kernel_record(name, max_abs, timing, bound_ms_by, library_ms=None):
    """The kernels line's record of one kernel; timing: time_kernel's
    (ms, plain_ms, ms_source)."""
    cuda_name, source, replaces = KERNELS[name]
    ms, plain_ms, ms_source = timing
    assert ms >= bound_ms_by[0], (name, ms, bound_ms_by)    # faster than the bound: a wrong count
    return dict(name=name, route='cuda', source=source, replaces=replaces,
                max_abs_err=max_abs, ms=ms, ms_source=ms_source, plain_ms=plain_ms,
                bound_ms=bound_ms_by[0], bound_by=bound_ms_by[1], library_ms=library_ms)


def time_kernel(torch, card, name, kern, plain, n_plain=N_TIMING):
    """(device ms per launch, the twin's ms per call, ms_source), logged.
    The device time is torch.profiler's (ms_source 'profiler': the kernel's
    and its helper kernels' device time per traced launch); when
    PROFILER_TRIES traces hold none of the kernel's events it is one CUDA
    graph replay of the calls (ms_source 'graph': the wrapper's zero-fills,
    helper kernels and the gaps between them included, so it reads higher
    than the profiler's)."""
    cuda_name = KERNELS[name][0]
    helpers = HELPER_KERNELS.get(name, ())
    dev_ms, source = None, 'profiler'
    for k in range(PROFILER_TRIES):
        dev = kernel_device_ms(kern, cuda_name, N_TIMING, helpers)
        if dev.ms is not None:
            dev_ms = dev.ms
            log(f'    {cuda_name}: {dev.kernel_ms:.4f} ms'
                + (f', {"/".join(helpers)}: {dev.helper_ms:.4f} ms' if helpers else '')
                + f' per launch ({dev.launches} of {N_TIMING} launches traced, try {k + 1})')
            break
        log(f'    {cuda_name}: no event in profiler trace {k + 1} of {N_TIMING} calls; '
            f'{len(dev.each)} other kernels in it, {dev.launches} launches of it')
    if dev_ms is None:
        dev_ms, source = graph_ms(kern, N_TIMING), 'graph'
        log(f'    {cuda_name}: no device time in {PROFILER_TRIES} profiler traces; one CUDA '
            f'graph replay of {N_TIMING} calls: {dev_ms:.4f} ms per call (ms_source graph: '
            f'the graph\'s gaps between kernels included)')
    kern_loop = loop_ms(kern, N_TIMING)
    plain_loop = loop_ms(plain, n_plain)
    call_ms = median_ms(kern, N_TIMING)
    log(f'  {name:28s} kernel device time {dev_ms:.4f} ms; '
        f'back-to-back per call: kernel {kern_loop:.4f} ms, twin {plain_loop:.4f} ms '
        f'({n_plain} calls); synchronized wrapper call (median): kernel {call_ms:.4f} ms '
        f'({card})')
    return dev_ms, plain_loop, source


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


def empty_launch_floor(torch):
    """'x.xxxx ms', the device time of one empty kernel launch (the card's
    floor per launch; it bounds nothing), or 'not in the trace' when
    PROFILER_TRIES torch.profiler traces hold no event of it."""
    from mbpol_openmm_plugin_tpu_torch.ops import _build
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(PROFILER_TRIES):
        ms = kernel_device_ms(lambda: lib.mbpol_empty_launch(stream), 'empty_kernel', N_TIMING).ms
        if ms is not None:
            return f'{ms:.4f} ms'
    return 'not in the trace'


def phase_kernels(torch, card, record):
    """Phase 3: K1/K2 against their twins at water256 and water2048."""
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_check as check
    from mbpol_openmm_plugin_tpu_torch.tools.dense_probe import dense_inputs

    floor = empty_launch_floor(torch)
    rate = transcendental_rate()
    tile = ED.TILE
    log(f'  empty kernel launch: {floor} device time (the card\'s floor per launch, '
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
            timing = time_kernel(torch, card, kname, kern, plain,
                                 N_TIMING if size == 'water256' else N_TIMING_TWIN_BS)
            ms = timing[0]
            rec = kernel_record(kname, max_abs[kname], timing, bounds[kname])
            if size == 'water256':
                record[kname] = rec
            log(f'  {size} {kname:28s} {ms:.4f} ms'
                + (f' (before the triangular form {DENSE_MS_BEFORE[kname]} ms)'
                   if size == 'water256' else '')
                + f', bound {bounds[kname][0]:.4f} ms ({bounds[kname][1]}), kernel / bound '
                f'{ms / bounds[kname][0]:.2f}, empty launch {floor} ({card})')
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
    sites, (tiles,) = pme.block_sites(params, pot.pme, pos, charges, block)
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
        timing = time_kernel(torch, card, kname, kern, plain, N_TIMING_TWIN_BS)
        ms = timing[0]
        record[kname] = kernel_record(kname, checks[kname][1], timing, bounds[kname])
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
    return MD4096_STEPS / wall


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
            timing = time_kernel(torch, card, kname, lambda: wrapper(poly, x),
                                 lambda: PF.PLAIN[wrapper](poly, x), N_TIMING_TWIN_BS)
            ms, plain_ms, _ = timing
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
                record[kname] = kernel_record(kname, max_abs[kname], timing, bounds[kname],
                                              lib_ms)
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
# (water256) and 40 + 40 (water14) to keep the script near two thirds of
# its time limit (2 + 4 until phase 29 was added)
REMD_BLOCKS = {'water256': (1, 3), 'water14': (1, 3)}


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


# phase 24: the app layer and the builder. The JAX app's own float32
# distance on the app-layer water256 single point (mbpol_bulk_energy.ini:
# -2374.9697 kcal/mol in float32, -2370.8889 in float64), |dE| in kcal/mol
# and max |dF| / max |F| (tools/app_reference.py, JAX on the CPU); phase
# 24 (a) holds the card against the port's CPU float64 at F32_BOUND_FACTOR
# times these.
APP_JAX_F32_DE_KCAL = 4.080772156066814
APP_JAX_F32_DF_REL = 0.003716450562885187
# the same tool's water256 fixture single point under SINGLE_POINT, total
# kcal/mol in JAX float32 and float64 (phase 4's reading, beside them)
FIXTURE_JAX_KCAL = {'float32': -2257.730108374163, 'float64': -2254.43185755652}
# the PDBs the INIs name, written from tests/fixtures/ by the port's writer
APP_PDBS = ('water14_cluster', 'water256_bulk', 'water3')
EXAMPLES = os.path.join(REPO, 'examples')
# each INI the phase runs, in order, with the steps cut to keep the phase
# near two minutes: {(section, key): value}
APP_RUNS = {
    'mbpol_config.ini': {},
    'example_ini/mbpol_cluster_energy.ini': {},
    'example_ini/mbpol_cluster_minimization.ini': {},
    'example_ini/mbpol_cluster_nve.ini': {},
    'example_ini/mbpol_bulk_energy.ini': {},
    'example_ini/mbpol_bulk_nve.ini': {},
    'example_ini/mbpol_bulk_nvt.ini': {},
    'example_ini/mbpol_bulk_npt.ini': {},
    'example_ini/mbpol_bulk_nve_respa.ini': {('integrator', 'equilibration_steps'): 2,
                                             ('integrator', 'production_steps'): 8,
                                             ('logging', 'save_energy_every'): 5,
                                             ('logging', 'save_positions_every'): 5},
    'example_ini/mbpol_bulk_nve_respa3.ini': {('integrator', 'equilibration_steps'): 1,
                                              ('integrator', 'production_steps'): 4,
                                              ('logging', 'save_energy_every'): 2,
                                              ('logging', 'save_positions_every'): 2},
    'example_ini/mbpol_bulk_npt_pimd.ini': {('integrator', 'equilibration_steps'): 10,
                                            ('integrator', 'production_steps'): 50,
                                            ('logging', 'save_energy_every'): 25,
                                            ('logging', 'save_positions_every'): 25},
    'example_ini/mbpol_cluster_pimd.ini': {('integrator', 'equilibration_steps'): 10,
                                           ('integrator', 'production_steps'): 40,
                                           ('logging', 'save_energy_every'): 20,
                                           ('logging', 'save_positions_every'): 20},
    'example_ini/mbpol_cluster_remd.ini': {('integrator', 'equilibration_steps'): 0,
                                           ('integrator', 'production_steps'): 50},
    'example_ini/mbpol_bulk_remd.ini': {('integrator', 'equilibration_steps'): 0,
                                        ('integrator', 'production_steps'): 25,
                                        ('logging', 'save_positions_every'): 25},
}
APP_TIMED_STEPS = 100        # app steps timed after the NVE script, its reporters attached
API_REL = 1e-5               # the per-force API's PME electrostatics against MBPol's term
THOLE_SCALE = (1.0, 1.0, 1.1, 0.95, 1.0)


def write_app_pdbs(directory):
    """The PDBs of the example INIs from their fixtures, by the port's
    writer (mbpol_openmm_plugin_tpu_torch/examples/make_inputs.py's)."""
    from mbpol_openmm_plugin_tpu_torch.examples import _common
    for name in APP_PDBS:
        _common.write_pdb(name, os.path.join(directory, name + '.pdb'))


def run_ini(torch, card, tmp, ini, cuts, platform=None):
    """Render examples/<ini> (its steps cut as `cuts` says) with the port's
    builder and run the script in-process in tmp, K1/K2 counts set to 0
    just before. Returns (the script's globals, its standard output, K1/K2
    launches, wall s)."""
    import configparser
    import io
    import runpy

    from mbpol_openmm_plugin_tpu_torch.app import builder
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED

    path = os.path.join(EXAMPLES, ini)
    name = os.path.splitext(os.path.basename(ini))[0] + ('' if platform is None else '_cpu')
    if cuts:
        cfg = configparser.ConfigParser()
        cfg.read(path)
        for (section, key), value in cuts.items():
            cfg[section][key] = str(value)
        path = os.path.join(tmp, name + '.ini')
        with open(path, 'w') as f:
            cfg.write(f)
    script = os.path.join(tmp, 'run_' + name + '.py')
    with open(script, 'w') as f:
        f.write(builder.render(path, platform=platform))
    out = io.StringIO()
    ED.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.chdir(tmp), contextlib.redirect_stdout(out):
        g = runpy.run_path(script, run_name='__main__')
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in ED.KERNELS}
    cut = ', '.join(f'[{sec}] {key} {value}' for (sec, key), value in cuts.items())
    log(f'  {ini}{" --platform " + platform if platform else ""}'
        f'{" (cut to " + cut + ")" if cut else ""}: wall {wall:.2f} s ({card}); K1/K2 launches '
        f'{launches}')
    return g, out.getvalue(), launches, wall


def numeric_rows(path):
    """The StateDataReporter log's header and its rows as floats (the
    clock-format 'Time Remaining' column left out)."""
    with open(path) as f:
        lines = f.read().splitlines()
    header = [h.strip('"') for h in lines[0].lstrip('#').split(',')]
    keep = [i for i, h in enumerate(header) if h != 'Time Remaining']
    rows = [[float(line.split(',')[i]) for i in keep] for line in lines[1:]]
    return [header[i] for i in keep], np.asarray(rows)


def printed_energy(text):
    import re
    return float(re.search(r'Potential energy: (\S+) kcal/mol', text).group(1))


def netcdf_forces(path):
    """The first frame's forces of an AMBER NetCDF file, kcal/mol/A."""
    from scipy.io import netcdf_file
    nc = netcdf_file(path, 'r', mmap=False)
    f = np.array(nc.variables['forces'][0], np.float64)
    nc.close()
    return f


def phase_app(torch, card, classical_rate):
    """Phase 24: the example INIs rendered by the port's builder and run on
    the card; the per-force API and with_updated_params."""
    import tempfile

    from scipy.io import netcdf_file

    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED

    def k12(launches):
        return min(launches.values())

    with tempfile.TemporaryDirectory() as tmp:
        write_app_pdbs(tmp)
        runs = {}
        for ini, cuts in APP_RUNS.items():
            runs[ini] = g, text, launches, wall = run_ini(torch, card, tmp, ini, cuts)
            name = os.path.splitext(os.path.basename(ini))[0]
            if name in ('mbpol_bulk_nve', 'mbpol_bulk_nvt', 'mbpol_bulk_npt'):
                captured = g['simulation']._core.captured
                log(f'    captured {captured}')
                assert captured, ini
            if 'bulk' in name:
                assert k12(launches) >= 1, (ini, launches)
            if name.startswith('mbpol_bulk_n') and 'pimd' not in name:
                log_name = g['simulation_name'] + '.log'
                header, rows = numeric_rows(os.path.join(tmp, log_name))
                every = next(r.reportInterval for r in g['simulation'].reporters
                             if getattr(r, '_file', None) == log_name)
                eq, n = g['equilibration_steps'], g['simulation_steps']
                log(f'    {log_name}: steps '
                    f'{rows[:, header.index("Step")].astype(int).tolist()}, last row '
                    + ', '.join(f'{h} {v:.4f}' for h, v in zip(header, rows[-1])))
                assert np.all(np.isfinite(rows)), rows
                assert np.array_equal(rows[:, header.index('Step')],
                                      [k for k in range(eq + 1, eq + n + 1) if k % every == 0])
                traj = os.path.join(tmp, g['simulation_name'] + '_trajectory.pdb')
                with open(traj) as f:
                    n_models = f.read().count('MODEL')
                assert n_models >= 1, traj
            for line in text.splitlines():
                if line.startswith(('slot,', 'step,', 'Potential energy')) or (
                        line[:1].isdigit() and ('remd' in name or 'pimd' in name)):
                    log(f'    | {line}')

        # (a) the water256 app single point against the port's CPU float64
        g, text, launches, _ = runs['example_ini/mbpol_bulk_energy.ini']
        e_card = printed_energy(text)
        f_card = netcdf_forces(os.path.join(tmp, 'bulk_energy.nc'))
        g64, text64, _, wall64 = run_ini(torch, card, tmp, 'example_ini/mbpol_bulk_energy.ini',
                                         {}, platform='CPU')
        assert g64['simulation'].potential.dtype == torch.float64
        e64 = printed_energy(text64)
        f64 = netcdf_forces(os.path.join(tmp, 'bulk_energy.nc'))
        de, df = abs(e_card - e64), float(np.max(np.abs(f_card - f64)) / np.max(np.abs(f64)))
        b_e = F32_BOUND_FACTOR * APP_JAX_F32_DE_KCAL
        b_f = F32_BOUND_FACTOR * APP_JAX_F32_DF_REL
        log(f'  (a) water256 app single point: card {e_card:.4f}, CPU float64 {e64:.4f} kcal/mol: '
            f'|dE| {de:.4f} (bound {b_e:.4f} = {F32_BOUND_FACTOR:g} x the JAX float32 '
            f'distance); max |dF| / max |F| {df:.4e} (bound {b_f:.4e}); K1/K2 launches '
            f'{launches}; the JAX fixture single point reads {FIXTURE_JAX_KCAL} kcal/mol')
        assert de <= b_e and df <= b_f, (de, df)
        assert k12(launches) >= 1, launches
        del g, g64

        # (b) NVE: app steps/s with its reporters, and the report edges' share
        g = runs['example_ini/mbpol_bulk_nve.ini'][0]
        sim = g['simulation']
        core = sim._core
        chunks = []
        core_step = core.step

        def counted(n, **kw):
            chunks.append(n)
            return core_step(n, **kw)
        core.step = counted
        ED.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.step(APP_TIMED_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        per_step = k12({k.__name__: k.launches for k in ED.KERNELS}) / APP_TIMED_STEPS
        core.step = core_step
        edge = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            core.potential._energy_forces_impl(core.state.positions, box=core.state.box)
            torch.cuda.synchronize()
            edge.append(time.perf_counter() - t1)
        edge_s = float(np.median(edge))
        rate = APP_TIMED_STEPS / wall
        log(f'  (b) {APP_TIMED_STEPS} more app steps of the NVE script with its reporters: '
            f'{wall:.3f} s = {rate:.2f} steps/s against phase 5\'s {classical_rate:.2f} ({card}); '
            f'{len(chunks)} chunks {chunks} to the report boundaries, each opened and closed by '
            f'a converged evaluation of {edge_s * 1e3:.1f} ms: the edges take '
            f'{2 * len(chunks) * edge_s / wall:.1%} of the wall (not gated); K1/K2 launches per '
            f'step {per_step:.2f}')
        assert per_step >= 1.0, per_step
        del g, sim, core

        # (c) NPT: barostat moves and the pressure column
        g = runs['example_ini/mbpol_bulk_npt.ini'][0]
        scale, attempted, accepted = g['simulation']._core._baro
        header, rows = numeric_rows(os.path.join(tmp, 'bulk_npt.log'))
        p = rows[:, header.index('Pressure (bar)')]
        log(f'  (c) NPT: barostat moves attempted {attempted}, accepted {accepted}; pressure '
            f'(bar) {np.round(p, 2).tolist()}; volume (nm^3) '
            f'{np.round(rows[:, header.index("Box Volume (nm^3)")], 4).tolist()}')
        assert attempted >= 1 and np.all(np.isfinite(p)), (attempted, p)
        del g

        # (d) the water14 cluster: NetCDF conventions, minimization
        nc = netcdf_file(os.path.join(tmp, 'water14_cluster.nc'), 'r', mmap=False)
        shapes = {k: nc.variables[k].shape for k in ('coordinates', 'velocities', 'forces')}
        finite = all(np.all(np.isfinite(nc.variables[k][:])) for k in shapes)
        conventions = (nc.Conventions, nc.ConventionVersion)
        nc.close()
        e0 = printed_energy(runs['example_ini/mbpol_cluster_energy.ini'][1])
        e_min = printed_energy(runs['example_ini/mbpol_cluster_minimization.ini'][1])
        log(f'  (d) water14_cluster.nc: {conventions}, {shapes}, finite {finite}; cluster '
            f'energy {e0:.4f} kcal/mol, after minimization {e_min:.4f}')
        assert conventions == (b'AMBER', b'1.0') and finite, (conventions, finite)
        assert all(v == (3, 56, 3) for v in shapes.values()), shapes
        assert e_min <= e0, (e_min, e0)

        # (e) PIMD and REMD branches
        for ini, key in (('example_ini/mbpol_bulk_npt_pimd.ini', 'metrics'),
                         ('example_ini/mbpol_cluster_pimd.ini', 'metrics'),
                         ('example_ini/mbpol_cluster_remd.ini', 'out'),
                         ('example_ini/mbpol_bulk_remd.ini', 'out')):
            out = runs[ini][0][key]
            pe = np.asarray(out['potential_energy'])
            extra = (f', barostat moves {out["barostat_attempted"]} attempted, '
                     f'{out["barostat_accepted"]} accepted' if 'barostat_attempted' in out
                     and 'npt' in ini else '')
            if 'acceptance' in out:
                extra += f', acceptance per pair {np.round(out["acceptance"], 3).tolist()}'
            log(f'  (e) {ini}: potential energy {np.round(pe, 2).tolist()} kJ/mol{extra}')
            assert np.all(np.isfinite(pe)), (ini, pe)
            if 'npt' in ini:
                assert out['barostat_attempted'] >= 1, out
        del runs
    torch.cuda.empty_cache()
    phase_api(torch, card)


def phase_api(torch, card):
    """Phase 24 (f): the per-force API's PME electrostatics and
    with_updated_params on the water256 fixture, on the card."""
    import dataclasses

    from mbpol_openmm_plugin_tpu_torch import api
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED

    system, pos = load_water256(torch, torch.device('cuda'), torch.float32)
    cfg = MBPolConfig(nonbonded_method='PME', cutoff=0.9, ewald_error_tolerance=1e-4)
    pot = MBPol(system, cfg)
    e, f, parts, _ = pot.energy_forces(pos)
    ep = pot.elec_params
    force = api.MBPolElectrostaticsForce()
    for i in range(system.n_atoms):
        force.addElectrostatics(float(ep.charges[i]), int(ep.mol_index[i]), int(ep.atom_type[i]),
                                float(ep.damping[i]), float(ep.polarity[i]))
    force.setNonbondedMethod(api.MBPolElectrostaticsForce.PME)
    force.setCutoffDistance(cfg.cutoff)
    force.setEwaldErrorTolerance(cfg.ewald_error_tolerance)
    force.setPeriodicBox(system.box)
    force.setMutualInducedTargetEpsilon(cfg.target_epsilon)
    force.setMutualInducedMaxIterations(cfg.max_iterations)
    assert force._pme_setup() == pot.pme, (force._pme_setup(), pot.pme)
    ED.reset_launch_counts()
    t0 = time.perf_counter()
    e_api, f_api = force.computeForceAndEnergy(pos)
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in ED.KERNELS}
    e_el = float(parts['electrostatics'])
    rel = abs(e_api - e_el) / abs(e_el)
    log(f'  (f) MBPolElectrostaticsForce (PME) {e_api:.4f} kJ/mol, MBPol electrostatics '
        f'{e_el:.4f}: relative {rel:.3e} (bound {API_REL:g}); forces finite '
        f'{bool(np.all(np.isfinite(f_api)))}; wall {wall * 1e3:.1f} ms ({card}); K1/K2 '
        f'launches {launches}')
    assert rel <= API_REL and np.all(np.isfinite(f_api)), rel
    assert min(launches.values()) >= 1, launches

    th = np.asarray(ep.thole, np.float64) * np.asarray(THOLE_SCALE)
    ED.reset_launch_counts()
    new = pot.with_updated_params(thole=th)
    got = new.energy_forces(pos)
    fresh = MBPol(system, dataclasses.replace(cfg, thole=tuple(th))).energy_forces(pos)
    back = new.with_updated_params(thole=ep.thole).energy_forces(pos)
    launches = {k.__name__: k.launches for k in ED.KERNELS}

    def same(a, b):
        return (bool(torch.equal(a[0], b[0])) and bool(torch.equal(a[1], b[1]))
                and all(bool(torch.equal(a[2][k], b[2][k])) for k in a[2]))
    same_fresh, same_back = same(got, fresh), same(back, (e, f, parts))
    log(f'  (f) with_updated_params(thole x {THOLE_SCALE}): electrostatics '
        f'{float(got[2]["electrostatics"]):.4f} kJ/mol (was {e_el:.4f}); the same bits as a '
        f'fresh MBPol with that thole: {same_fresh}; back to the original thole, the '
        f'original bits: {same_back}; K1/K2 launches {launches}')
    assert float(got[2]['electrostatics']) != e_el
    assert same_fresh and same_back
    assert min(launches.values()) >= 3, launches


# phases 25-28: the large-box path. Bounds from the JAX package's own
# float32 readings at the water256 fixture (tools/large_n_reference.py, JAX
# on the CPU): sparse against dense under SINGLE_POINT, compact_eval (True
# and 'rebuild', the larger reading of the two per quantity) against no
# compaction under for_dynamics(target_epsilon=1e-4), the reference
# triplets' three-body energy in float32 against float64 (kJ/mol; forces
# as max |dF| / max |F|). Each is held at F32_BOUND_FACTOR x the reading.
SPARSE_JAX_F32 = {'one_body': 0.0, 'two_body': 0.0, 'three_body': 0.0,
                  'dispersion': 0.0029296875, 'electrostatics': 0.1025390625,
                  'total': 0.10546875, 'forces_rel': 1.2412495281228016e-05}
COMPACT_JAX_F32 = {'one_body': 0.0, 'two_body': 0.0009765625, 'three_body': 9.1552734375e-05,
                   'dispersion': 0.0, 'electrostatics': 0.0, 'total': 0.0009765625,
                   'forces_rel': 0.0}
REFERENCE_3B_JAX_F32 = 4.035246254075105
SPARSE_REPS = REPS                # water4096 sparse = water256 x 2 x 2 x 4
SPARSE_MD_STEPS = 20
COMPACT_MD_STEPS = 200
COMPACT_TIMED_STEPS = 100
REPS8192 = (2, 4, 4)              # water8192 = water256 x 2 x 4 x 4
N_COPIES8192 = int(np.prod(REPS8192))
MD8192_STEPS = 20
CHUNK_REL = 1e-6
DRIFT_STEPS, DRIFT_SEG = 2000, 100


def load_replicated(torch, reps):
    """The water256 fixture repeated reps times, on the card, float32."""
    from mbpol_openmm_plugin_tpu_torch.system import compute_virtual_sites, replicate
    system, pos = load_water256(torch, torch.device('cuda'), torch.float32)
    big, pos = replicate(system, pos, reps)
    return big, compute_virtual_sites(big, pos)


def term_distances(torch, a, b):
    """{term: |dE| kJ/mol, 'total', 'forces_rel': max |dF| / max |F|} of two
    evaluations (E, F, parts, diag)."""
    out = {k: abs(float(a[2][k]) - float(b[2][k])) for k in b[2]}
    out['total'] = abs(float(a[0]) - float(b[0]))
    out['forces_rel'] = float((a[1] - b[1]).abs().max() / b[1].abs().max())
    return out


def within_readings(name, got, readings, failures):
    """Log each distance beside F32_BOUND_FACTOR x its JAX reading; a
    distance over its bound is a failure."""
    for k, v in got.items():
        bound_k = F32_BOUND_FACTOR * readings[k]
        ok = v <= bound_k
        log(f'    {name:28s} {k:14s} {v:.6e} (bound {bound_k:.6e} = {F32_BOUND_FACTOR} x JAX '
            f'{readings[k]:.6e}) {"ok" if ok else "FAIL"}')
        if not ok:
            failures.append(f'{name}.{k}')


@contextlib.contextmanager
def dense_twins_on_the_card():
    """Inside the block the dense mode's direct space runs the plain twins
    of K1/K2 on the card (float32 plain PyTorch, as the JAX package's XLA
    path on the CPU) instead of the kernels."""
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
    saved = ED.fixed_field_and_scf_factors, ED.direct_energy_force_pot
    ED.fixed_field_and_scf_factors = ED.fixed_field_and_scf_factors_plain
    ED.direct_energy_force_pot = ED.direct_energy_force_pot_plain
    try:
        yield
    finally:
        ED.fixed_field_and_scf_factors, ED.direct_energy_force_pot = saved


def run_md(torch, sim, steps):
    """(out, wall s) of sim.step(steps), synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sim.step(steps)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_sparse(torch, card, pot256, e256, f256, parts256, block_rate):
    """Phase 25: the sparse electrostatics on the card: (a) water256 against
    phase 4's dense single point; (b) water4096 against water256 x 16;
    (c) 20 captured NVE steps at water4096."""
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig

    failures = []
    system, pos = load_water256(torch, torch.device('cuda'), torch.float32)
    sp = MBPol(system, MBPolConfig(electrostatics_mode='sparse', **SINGLE_POINT))
    t0 = time.perf_counter()
    e_s, f_s, parts_s, diag = sp.energy_forces(pos)
    torch.cuda.synchronize()
    log(f'  (a) water256 sparse/{sp.disp_mode}: E {float(e_s):.4f} kJ/mol (dense {e256:.4f}), '
        f'SCF iterations {int(diag["iterations"])}, water-pair capacity {sp.elec_pair_cap}, '
        f'wall {(time.perf_counter() - t0) * 1e3:.1f} ms ({card})')
    assert bool(diag['converged']) and not bool(diag['elec_pair_overflow'])
    # the JAX reading compares two plain float32 routes; so does the gate:
    # the dense mode with K1/K2's plain twins on the card
    with dense_twins_on_the_card():
        plain = MBPol(system, MBPolConfig(**SINGLE_POINT)).energy_forces(pos)
    within_readings('sparse vs dense (twins)', term_distances(torch, (e_s, f_s, parts_s), plain),
                    SPARSE_JAX_F32, failures)
    kern = term_distances(torch, (e256, f256, parts256), plain)
    vs4 = term_distances(torch, (e_s, f_s, parts_s), (e256, f256, parts256))
    log(f'  against phase 4 (dense, K1/K2): electrostatics {vs4["electrostatics"]:.3e} kJ/mol, '
        f'forces {vs4["forces_rel"]:.3e} of max |F|; the kernels\' share, dense K1/K2 against '
        f'dense twins: {kern["electrostatics"]:.3e} kJ/mol, forces {kern["forces_rel"]:.3e} '
        f'(bounds nothing; phase 3 holds the kernels to their twins)')

    # (b) the replicated box
    grid = tuple(g * r for g, r in zip(pot256.pme.grid, SPARSE_REPS))
    big, pos_b = load_replicated(torch, SPARSE_REPS)
    torch.cuda.reset_peak_memory_stats()
    pot = MBPol(big, MBPolConfig(pme_grid=grid, electrostatics_mode='sparse', **SINGLE_POINT))
    pot.tune_capacities(pos_b)
    t0 = time.perf_counter()
    e, f, _, diag = pot.energy_forces(pos_b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    e_rel = abs(float(e) / N_COPIES - float(e_s)) / abs(float(e_s))
    f_rel = float((f.reshape(N_COPIES, -1, 3) - f_s[None]).abs().max() / f_s.abs().max())
    terms = dict(SINGLE_POINT, terms=('electrostatics', 'dispersion'), electrostatics_mode='sparse')
    fs = MBPol(system, MBPolConfig(**terms)).energy_forces(pos)[1]
    fb = MBPol(big, MBPolConfig(pme_grid=grid, **terms)).tune_capacities(pos_b).energy_forces(
        pos_b)[1]
    fs_rel = float((fb.reshape(N_COPIES, -1, 3) - fs[None]).abs().max() / fs.abs().max())
    log(f'  (b) water4096 sparse/{pot.disp_mode} after tune_capacities (water-pair capacity '
        f'{pot.elec_pair_cap}), PME grid {grid}: E per copy {float(e) / N_COPIES:.5f} vs '
        f'{float(e_s):.5f}, relative {e_rel:.3e} (bound {REPLICA_E_REL}); forces electrostatics '
        f'+ dispersion {fs_rel:.3e} (bound {REPLICA_F_REL}), whole {f_rel:.3e} (bound '
        f'{REPLICA_F_WHOLE}); SCF iterations {int(diag["iterations"])}; wall {wall * 1e3:.1f} ms; '
        f'peak device memory {peak:.2f} GiB ({card})')
    assert bool(diag['converged'])
    assert not any(bool(v) for k, v in diag.items() if k.endswith('_overflow')), diag
    for name, v, b in (('e_rel', e_rel, REPLICA_E_REL), ('fs_rel', fs_rel, REPLICA_F_REL),
                       ('f_rel', f_rel, REPLICA_F_WHOLE)):
        if not v <= b:
            failures.append(f'replication.{name}')
    del pot, e, f, fb
    torch.cuda.empty_cache()

    # (c) captured NVE steps
    md = MBPol(big, MBPolConfig.for_dynamics(electrostatics_mode='sparse')).tune_capacities(pos_b)
    sim = Simulation(md, SimulationConfig(dt=0.0002, nlist_rebuild_interval='auto'))
    assert sim.captured
    sim.set_positions(pos_b)
    torch.cuda.reset_peak_memory_stats()
    out, wall = run_md(torch, sim, SPARSE_MD_STEPS)   # raises on NaN, overflow or a failed SCF
    e_tot = out['step_total_energy']
    log(f'  (c) water4096 sparse MD: {SPARSE_MD_STEPS} steps in {wall:.3f} s = '
        f'{SPARSE_MD_STEPS / wall:.3f} steps/s (block/pairs, phase 8: {block_rate:.3f}), '
        f'including the two converged evaluations and the capture '
        f'({sim.capture_ms[0]:.1f} ms); E_tot {e_tot[0]:.4f} -> {e_tot[-1]:.4f} kJ/mol; list '
        f'rebuilds {sim.list_rebuilds}; peak device memory '
        f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({card})')
    assert np.all(np.isfinite(e_tot))
    del sim, md
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f'phase 25: {failures}')


def timed_md(torch, pot, pos, steps):
    """(out, sim, ms per step) of captured NVE steps from the fixture at
    rest: 20 steps (the capture), then `steps` from rest (out), then 20 from
    rest again; ms per step is the difference of the last two walls over
    steps - 20 (each call's converged edges cancel)."""
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
    sim = Simulation(pot, SimulationConfig(dt=0.0002, nlist_rebuild_interval='auto'))
    assert sim.captured
    runs = []
    for n in (20, steps, 20):
        sim.set_positions(pos)
        runs.append(run_md(torch, sim, n))
    return runs[1][0], sim, (runs[1][1] - runs[2][1]) / (steps - 20) * 1e3


def phase_compact(torch, card, record, quad_steps_per_s):
    """Phase 26: list compaction and the reference triplets at water256 dense."""
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.models.three_body import three_body_variables
    from mbpol_openmm_plugin_tpu_torch.models.two_body import two_body_variables
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
    from mbpol_openmm_plugin_tpu_torch.ops import pip_fused as PF
    from mbpol_openmm_plugin_tpu_torch.ops import pip_fused_check as check

    failures = []
    system, pos = load_water256(torch, torch.device('cuda'), torch.float32)
    cfg = dict(target_epsilon=1e-4)
    for impl in ('quad', 'quad_bf16'):
        plain = MBPol(system, MBPolConfig.for_dynamics(pip_impl=impl, **cfg)).energy_forces(pos)
        for ce in (True, 'rebuild'):
            ED.reset_launch_counts()
            PF.reset_launch_counts()
            pot = MBPol(system, MBPolConfig.for_dynamics(pip_impl=impl, compact_eval=ce, **cfg))
            got = pot.energy_forces(pos)
            torch.cuda.synchronize()
            diag = got[3]
            rows = (f'2B {int(diag["n_pairs_active"])} of {int(diag["n_pairs"])} built, '
                    f'3B {int(diag["n_triplets_active"])} of {int(diag["n_triplets"])}'
                    if ce is True else f'2B {int(diag["n_pairs"])} / 3B '
                    f'{int(diag["n_triplets"])} within cutoff + skin')
            launches = {k.__name__: k.launches for k in ED.KERNELS + PF.KERNELS if k.launches}
            log(f'  {impl} compact_eval={ce!r}: eval rows {pot.pair_eval_cap} / '
                f'{pot.trip_eval_cap} of {pot.pair_cap} / {pot.trip_cap} ({rows}); launches '
                f'{launches}')
            assert not any(bool(v) for k, v in diag.items() if k.endswith('_overflow')), diag
            assert launches.get('fixed_field_and_scf_factors', 0) >= 1
            if impl == 'quad_bf16':
                assert launches.get('pip_quad_product_energy_grad', 0) >= 2, launches
            dist = term_distances(torch, got, plain)
            if impl == 'quad_bf16':
                within_readings(f'{impl} {ce!r} vs plain', dist, COMPACT_JAX_F32, failures)
            else:
                # cuBLAS's float32 GEMM rounds a row differently with the
                # batch length, which the JAX reading (XLA on the CPU, each
                # row the same at any length) does not see: held to phase
                # 7's list-length rows (energy per term 1e-4 relative, forces
                # REPLICA_F_WHOLE), the JAX reading logged beside
                for k, v in dist.items():
                    b = (REPLICA_F_WHOLE if k == 'forces_rel'
                         else REPLICA_E_REL * abs(float(plain[0] if k == 'total'
                                                       else plain[2][k])))
                    ok = v <= b
                    log(f'    {impl} {ce!r} vs plain {k:14s} {v:.6e} (bound {b:.6e}; JAX '
                        f'float32 {COMPACT_JAX_F32[k]:.6e}) {"ok" if ok else "FAIL"}')
                    if not ok:
                        failures.append(f'{impl}.{ce}.{k}')

    # kernel #10 on the compacted batches against its twin, and its time
    pot = MBPol(system, MBPolConfig.for_dynamics(compact_eval=True))
    (pl, tl), _ = pot.build_neighbor_lists(pos)
    (pl, tl), _ = pot._compact_lists(pos, (pl, tl), system.box)
    with torch.no_grad():
        xs = {'poly2b': two_body_variables(system, pos, pl[0], pl[1]).contiguous(),
              'poly3b': three_body_variables(system, pos, tl[0], tl[1]).contiguous()}
    wrapper = PF.pip_quad_product_energy_grad
    for poly, x in xs.items():
        rows, err = check.kernel_rows(wrapper, poly, x, physical=True)
        for row in rows:
            log(f'  {wrapper.__name__:28s} {poly} compacted [{x.shape[0]:5d}] {row}')
            if not row.ok:
                failures.append(f'kernel10.{poly}.{row.output}.{row.measure}')
        ms, plain_ms, _ = time_kernel(torch, card, wrapper.__name__, lambda: wrapper(poly, x),
                                      lambda: PF.PLAIN[wrapper](poly, x), N_TIMING_TWIN_BS)
        log(f'  {wrapper.__name__:28s} {poly} compacted [{x.shape[0]}, {x.shape[1]}]: kernel '
            f'{ms:.4f} ms, twin {plain_ms:.4f} ms, max |err| {err:.3e} ({card})')

    # MD: 200 captured 'rebuild' steps under phase 5's gate; ms per step
    # with and without compaction
    ms = {}
    for ce, steps in ((None, COMPACT_TIMED_STEPS), (True, COMPACT_TIMED_STEPS),
                      ('rebuild', COMPACT_MD_STEPS)):
        pot = MBPol(system, MBPolConfig.for_dynamics(compact_eval=ce))
        ED.reset_launch_counts()
        out, sim, ms[ce] = timed_md(torch, pot, pos, steps)
        launches = {k.__name__: k.launches for k in ED.KERNELS}
        log(f'  MD compact_eval={ce!r}: {ms[ce]:.3f} ms per step (captured, the difference of '
            f'{steps} and 20 steps; phase 5 reads {1e3 / quad_steps_per_s:.3f} ms per step with '
            f'the edges); list rebuilds {sim.list_rebuilds}; K1/K2 {launches} ({card})')
        if ce == 'rebuild':
            e_tot = out['step_total_energy']
            fit = second_half_fit(e_tot)
            log(f'  rebuild MD: E_tot {e_tot[0]:.4f} -> {e_tot[-1]:.4f} kJ/mol, fitted change '
                f'over the second half {fit:+.4f} kJ/mol (bound |fit| <= {MD_FIT_TOL_KJ})')
            assert np.all(np.isfinite(e_tot)) and abs(fit) <= MD_FIT_TOL_KJ, fit
            assert all(n >= steps for n in launches.values()), launches
        del sim
    log(f'  compaction per step: True {ms[True] - ms[None]:+.3f} ms, rebuild '
        f'{ms["rebuild"] - ms[None]:+.3f} ms against {ms[None]:.3f} ms uncompacted ({card})')

    # the reference triplets: the card's float32 against the CPU float64
    cfg_ref = dict(triplet_semantics='reference', **SINGLE_POINT)
    got = MBPol(system, MBPolConfig(**cfg_ref)).energy_forces(pos)
    sys64, _ = load_water256(torch, torch.device('cpu'), torch.float64)
    ref = MBPol(sys64, MBPolConfig(terms=('three_body',), **cfg_ref), device='cpu').energy_forces(
        pos.cpu().double())
    n_t, n_t64 = int(got[3]['n_triplets']), int(ref[3]['n_triplets'])
    d3 = abs(float(got[2]['three_body']) - float(ref[2]['three_body']))
    bound3 = F32_BOUND_FACTOR * REFERENCE_3B_JAX_F32
    log(f'  reference triplets: {n_t} (CPU float64 at the same positions: {n_t64}); three-body '
        f'{float(got[2]["three_body"]):.6f} vs {float(ref[2]["three_body"]):.6f} kJ/mol, |d| '
        f'{d3:.6e} (bound {bound3:.6e} = {F32_BOUND_FACTOR} x JAX {REFERENCE_3B_JAX_F32:.6e})')
    if n_t != n_t64 or not d3 <= bound3:
        failures.append('reference_triplets')
    if failures:
        raise AssertionError(f'phase 26: {failures}')


def phase_water8192(torch, card):
    """Phase 27: water8192 through the planner, the block kernels and the
    chunked PME grid."""
    from mbpol_openmm_plugin_tpu_torch.models import pme as P
    from mbpol_openmm_plugin_tpu_torch.models import electrostatics as elec
    from mbpol_openmm_plugin_tpu_torch.models import potential as MP
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as BS
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_check as check
    from mbpol_openmm_plugin_tpu_torch.parallel.plan import plan_capacities
    from mbpol_openmm_plugin_tpu_torch.system import oxygen_positions

    failures = []
    sys256, pos256 = load_water256(torch, torch.device('cuda'), torch.float32)
    pot256 = MP.MBPol(sys256, MP.MBPolConfig(**SINGLE_POINT))
    e256, f256, _, _ = pot256.energy_forces(pos256)
    system, pos = load_replicated(torch, REPS8192)
    grid = tuple(g * r for g, r in zip(pot256.pme.grid, REPS8192))
    cfg_sp = MP.MBPolConfig(pme_grid=grid, **SINGLE_POINT)
    t0 = time.perf_counter()
    plan = plan_capacities(system.n_waters, system.box, config=cfg_sp, positions=pos)
    t_plan = time.perf_counter() - t0
    log(f'  water8192: {system.n_waters} waters, {pos.shape[0]} sites, box '
        f'{tuple(round(float(b), 5) for b in system.box)} nm; plan_capacities from the positions '
        f'(native counts) {t_plan:.2f} s:')
    for line in plan.describe().splitlines():
        log('    ' + line)
    # the plan's caps against the port's torch counts on the card
    counts = MP.ListCounts(oxygen_positions(system, pos), system.box)
    caps = MP.list_capacities(counts, cfg_sp, system.n_waters, 1.15, plan.elec_mode,
                              plan.disp_pair_cap is not None)
    same = {k: (getattr(plan, k), v) for k, v in caps.items()}
    log(f'  plan vs torch counts: {same}')
    if any(a != b for a, b in same.values()):
        failures.append('plan_counts')
    assert plan.elec_mode == 'block', plan.elec_mode
    torch.cuda.reset_peak_memory_stats()
    pot = MP.MBPol(system, cfg_sp, plan=plan)
    assert pot._block_info['tile_pair_capacity'] == plan.tile_pair_capacity
    n = pos.shape[0]
    nx, ny, nz = grid
    log(f'  PME grid {grid}: site chunks of {P._sep_chunk(n, ny * nz)} (spread; dipoles '
        f'{P._sep_chunk(3 * n, ny * nz)} of {3 * n} rows) and {P._sep_chunk(n, 3 * nx * ny)} '
        f'(read-back) of {n} sites (_SEP_CHUNK_ELEMS {P._SEP_CHUNK_ELEMS})')

    # the block kernels against their twins at this size
    params, block = pot.elec_params, pot._block_info
    charges, _ = elec.assemble_charges(params, pos)
    sites, (tiles,) = P.block_sites(params, pot.pme, pos, charges, block)
    polarity = torch.as_tensor(params.polarity[block['site_perm']], dtype=pos.dtype,
                               device=pos.device)
    consts = ED.DirectConsts.from_setup(pot.pme, params.thole)
    checks = check.block_kernel_rows(sites, polarity, tiles, n, consts, block['line_capacity'])
    torch.cuda.synchronize()
    for kname, (rows, _) in checks.items():
        for row in rows:
            log(f'  {kname:28s} {row}')
            if not row.ok:
                failures.append(f'{kname}.{row.output}.{row.entries}.{row.measure}')
    field, lines = BS.fixed_field_and_scf_lines(sites, n, tiles, consts, block['line_capacity'])
    mu = (polarity[:, None] * field).contiguous()
    mu_pad = BS.pad_rows(mu, sites.shape[0])
    log(f'  tile pairs {int(tiles.n_act)} of capacity {tiles.capacity}; s3/s5 lines: capacity '
        f'{block["line_capacity"]}, max per slab {int(lines.count.max())}, overflow '
        f'{bool(lines.overflow())}, {lines.nbytes() / 1e9:.4f} GB')
    assert not bool(lines.overflow())
    for kname, kern in (
            ('fixed_field_and_scf_lines',
             lambda: BS.fixed_field_and_scf_lines(sites, n, tiles, consts,
                                                  block['line_capacity'])),
            ('scf_dipole_field_bs',
             lambda: BS.scf_dipole_field_bs(sites, lines, mu_pad, tiles, n, consts)),
            ('direct_energy_force_pot_bs',
             lambda: BS.direct_energy_force_pot_bs(sites, mu, n, tiles, consts))):
        dev = kernel_device_ms(kern, KERNELS[kname][0], N_TIMING, HELPER_KERNELS.get(kname, ()))
        log(f'  {kname:28s} water8192 device time '
            f'{"not in the trace" if dev.ms is None else f"{dev.ms:.4f} ms"} per launch '
            f'({dev.launches} launches traced) ({card})')
    del field, lines, mu, mu_pad, checks
    torch.cuda.empty_cache()

    # the single point against water256 x 32
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    e, f, _, diag = pot.energy_forces(pos)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e6
    e_rel = abs(float(e) / N_COPIES8192 - float(e256)) / abs(float(e256))
    f_rel = float((f.reshape(N_COPIES8192, -1, 3) - f256[None]).abs().max() / f256.abs().max())
    terms = dict(SINGLE_POINT, terms=('electrostatics', 'dispersion'))
    fs256 = MP.MBPol(sys256, MP.MBPolConfig(**terms)).energy_forces(pos256)[1]
    cfg_t = MP.MBPolConfig(pme_grid=grid, **terms)
    fs = MP.MBPol(system, cfg_t, plan=plan_capacities(system.n_waters, system.box, config=cfg_t,
                                                      positions=pos)).energy_forces(pos)[1]
    fs_rel = float((fs.reshape(N_COPIES8192, -1, 3) - fs256[None]).abs().max()
                   / fs256.abs().max())
    log(f'  single point: E per copy {float(e) / N_COPIES8192:.5f} vs {float(e256):.5f} kJ/mol, '
        f'relative {e_rel:.3e} (bound {REPLICA_E_REL}); forces electrostatics + dispersion '
        f'{fs_rel:.3e} (bound {REPLICA_F_REL}), whole {f_rel:.3e} (bound {REPLICA_F_WHOLE}); SCF '
        f'iterations {int(diag["iterations"])}; wall {wall * 1e3:.1f} ms; '
        f'mem_per_device_mb {plan.mem_per_device_mb:.1f} MB (the plan) vs '
        f'torch.cuda.max_memory_allocated {peak:.1f} MB ({card})')
    assert bool(diag['converged'])
    assert not any(bool(v) for k, v in diag.items() if k.endswith('_overflow')), diag
    for name, v, b in (('e_rel', e_rel, REPLICA_E_REL), ('fs_rel', fs_rel, REPLICA_F_REL),
                       ('f_rel', f_rel, REPLICA_F_WHOLE)):
        if not v <= b:
            failures.append(f'replication.{name}')
    del f, fs
    torch.cuda.empty_cache()

    # the spread and the read-back unchunked against chunked
    box = P.box_tuple(pot.pme)
    S = P._spline_matrices(pot.pme, pos, box)
    charges, _ = elec.assemble_charges(params, pos)
    wx = charges[:, None] * S[0][..., 0]
    out = {}
    chunk = P._SEP_CHUNK_ELEMS
    for name, elems in (('chunked', chunk), ('unchunked', 1 << 62)):
        P._SEP_CHUNK_ELEMS = elems
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        g = P._spread_separable(pot.pme, wx, S[1][..., 0], S[2][..., 0])
        phi = P._readback_phi10(g, *S)
        torch.cuda.synchronize()
        out[name] = (g, phi, (torch.cuda.max_memory_allocated() - base) / 2 ** 30)
    P._SEP_CHUNK_ELEMS = chunk
    g_rel = float((out['chunked'][0] - out['unchunked'][0]).abs().max()
                  / out['unchunked'][0].abs().max())
    p_rel = float((out['chunked'][1] - out['unchunked'][1]).abs().max()
                  / out['unchunked'][1].abs().max())
    log(f'  spread / read-back chunked vs unchunked: {g_rel:.3e} / {p_rel:.3e} of max (bound '
        f'{CHUNK_REL}); peak memory above the inputs {out["chunked"][2]:.3f} GiB chunked, '
        f'{out["unchunked"][2]:.3f} GiB unchunked ({card})')
    if not (g_rel <= CHUNK_REL and p_rel <= CHUNK_REL):
        failures.append('chunked_grid')
    del out, S, wx, pot
    torch.cuda.empty_cache()

    # 20 captured NVE steps under for_dynamics through a plan
    cfg_md = MP.MBPolConfig.for_dynamics(pme_grid=grid)
    plan_md = plan_capacities(system.n_waters, system.box, config=cfg_md, positions=pos)
    md = MP.MBPol(system, cfg_md, plan=plan_md)
    sim = Simulation(md, SimulationConfig(dt=0.0002, nlist_rebuild_interval='auto'))
    assert sim.captured
    sim.set_positions(pos)
    BS.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out, wall = run_md(torch, sim, MD8192_STEPS)   # raises on NaN, overflow or a failed SCF
    launches = {k.__name__: k.launches for k in BS.KERNELS}
    e_tot = out['step_total_energy']
    log(f'  water8192 MD: {MD8192_STEPS} steps in {wall:.3f} s = {MD8192_STEPS / wall:.3f} '
        f'steps/s including the converged edges and the capture ({sim.capture_ms[0]:.1f} ms); '
        f'E_tot {e_tot[0]:.4f} -> {e_tot[-1]:.4f} kJ/mol; launches {launches}; peak device memory '
        f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB (plan: '
        f'{plan_md.mem_per_device_mb:.1f} MB) ({card})')
    assert np.all(np.isfinite(e_tot))
    assert all(v >= MD8192_STEPS for v in launches.values()), launches
    del sim, md
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f'phase 27: {failures}')


def phase_drift(torch, card):
    """Phase 28: the drift tool (tools/nve_drift.py) on water256,
    for_dynamics, plain and --kahan."""
    from mbpol_openmm_plugin_tpu_torch.tools import nve_drift
    for kahan in (False, True):
        out = nve_drift.run(steps=DRIFT_STEPS, therm=0, seg=DRIFT_SEG, kahan=kahan, echo=False)
        # phase 5's bound on the fitted change over 100 steps of 0.2 fs
        fit100 = out['drift_kJmol_per_ns'] * 1e-3 * 100 * 0.2e-3
        log(f'  {"kahan" if kahan else "plain"}: {DRIFT_STEPS} steps at '
            f'{out["steps_per_second"]:.2f} steps/s, T {out["temperature_K"]:.1f} K, drift '
            f'{out["drift_kJmol_per_ns"]:+.2f} kJ/mol/ns = {out["drift_K_per_ns"]:+.2f} K/ns over '
            f'{out["window_ps"]:.2f} ps, the fit per 100 steps {fit100:+.4f} kJ/mol (bound '
            f'{MD_FIT_TOL_KJ}) ({card})')
        assert np.isfinite(fit100) and not out['nan'] and not out['neighbor_overflow'], out
        assert abs(fit100) <= MD_FIT_TOL_KJ, fit100


# phase 29: the device mesh on the one card, MESH_SHARDS shards on cuda:0
# (parallel/mesh.py; a mesh may name a device more than once). The full-grid
# row kernels (#3/#4) launch once per shard; their ms per launch is read at
# one shard's rows of water256 (what the meshed main path launches); (b)
# holds the meshed single point to phase 4's settings with the SCF at
# DIIS_EPS on both sides, the electrostatics within F32_BOUND_FACTOR x the
# JAX float32 distance of this input (JAX_F32_DISTANCE['water256_pme'])
MESH_SHARDS = 4
MESH_MD_STEPS = 200
MESH_EAGER_STEPS = 10
MESH_PIMD_STEPS = 10
MESH_REMD_R, MESH_REMD_INTERVAL = 8, 3
ROW_KERNELS = ('fixed_field_and_scf_factors_rows', 'direct_energy_force_pot_rows')
TERM_REL = 1e-4


def card_mesh(torch, k=MESH_SHARDS, devices=None):
    from mbpol_openmm_plugin_tpu_torch.parallel.mesh import make_mesh
    if devices is None:
        return make_mesh(devices=[torch.device('cuda', 0)] * k)
    return make_mesh(devices)


def rel_rows(name, kern, ref, bound_rel):
    """(ok, max |kern - ref| / max |ref|), logged."""
    d = float((kern - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
    ok = d <= bound_rel
    log(f'    {name:40s} max |d| / max |ref| {d:.3e} (bound {bound_rel:g}) '
        f'{"ok" if ok else "FAIL"}')
    return ok, d


def phase_mesh_kernels(torch, card, record, mesh):
    """Phase 29 (a): the full-grid row kernels #3/#4 shard by shard against
    their twins (every shard, or shard 0 and the last at water4096), two
    launches on the same inputs bit for bit, and over the whole row range
    against K1/K2 (triangular), at MESH_DENSE_REPS' sizes; one shard's
    launch timed beside its bound, its twin, K1/K2, the earlier design and the
    empty-launch floor."""
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_check as check
    from mbpol_openmm_plugin_tpu_torch.parallel import mesh as M
    from mbpol_openmm_plugin_tpu_torch.tools.dense_probe import dense_inputs

    rate = transcendental_rate()
    floor = empty_launch_floor(torch)
    log(f'  empty kernel launch: {floor} device time (the card\'s floor per launch)')
    failures = []
    for size, reps in MESH_DENSE_REPS.items():
        sites, polarity, consts = dense_inputs(reps)
        n = sites.shape[0]
        n_pad = M.padded_for_mesh(n, mesh.size)
        ranges = M.row_ranges(n_pad, mesh)
        twin_shards = (0, mesh.size - 1) if size in TWIN_ENDS_ONLY else range(mesh.size)
        elem_bound = check.ELEM_BS if size in TWIN_ENDS_ONLY else check.ELEM
        tri1 = ED.fixed_field_and_scf_factors(sites, consts)
        mu = (polarity[:, None] * tri1[0]).contiguous()
        tri2 = ED.direct_energy_force_pot(sites, mu, consts)
        torch.cuda.synchronize()
        log(f'  {size}: {n} sites, padded {n_pad}, {mesh.size} shards of {n_pad // mesh.size} '
            f'rows x {n_pad} columns; twin rows on shards {list(twin_shards)}')
        max_abs = {k: 0.0 for k in ROW_KERNELS}
        outs1, outs2, n_in = [], [], []
        for k, (lo, hi) in enumerate(ranges):
            k1 = ED.fixed_field_and_scf_factors_rows(sites, lo, hi, consts, n_pad)
            k2 = ED.direct_energy_force_pot_rows(sites, mu, lo, hi, consts)
            again = (ED.fixed_field_and_scf_factors_rows(sites, lo, hi, consts, n_pad)
                     + ED.direct_energy_force_pot_rows(sites, mu, lo, hi, consts))
            torch.cuda.synchronize()
            same = all(bool(torch.equal(a, b)) for a, b in zip(k1 + k2, again))
            del again
            if not same:
                failures.append(f'{size}.{k}.two_launches')
            rows = []
            if k in twin_shards:
                t1 = ED.fixed_field_and_scf_factors_rows_plain(sites, lo, hi, consts, n_pad)
                t1_64 = ED.fixed_field_and_scf_factors_rows_plain(sites.double(), lo, hi, consts,
                                                                  n_pad)
                t2 = ED.direct_energy_force_pot_rows_plain(sites, mu, lo, hi, consts)
                rows = [('fixed_field_and_scf_factors_rows', r)
                        for r in check.k1_rows_range(sites, polarity, lo, hi, k1, t1, t1_64,
                                                     elem_bound)]
                rows += [('direct_energy_force_pot_rows', r) for r in check.k2_rows(
                    (k2[0].sum(), k2[1], k2[2]), (t2[0].sum(), t2[1], t2[2]))]
                if size in TWIN_ENDS_ONLY:
                    e3, e5 = check.twin_elem_range(sites, polarity, lo, hi, t1, t1_64)
                    log(f'  {size} shard {k}: the float32 twin\'s own per-entry distance from '
                        f'float64 on the polarizable pairs: s3 {e3:.3e}, s5 {e5:.3e} (ELEM '
                        f'{check.ELEM:g}, ELEM_BS {check.ELEM_BS:g})')
                max_abs['fixed_field_and_scf_factors_rows'] = max(
                    max_abs['fixed_field_and_scf_factors_rows'],
                    max(float((a - b).abs().max()) for a, b in zip(k1, t1)))
                max_abs['direct_energy_force_pot_rows'] = max(
                    max_abs['direct_energy_force_pot_rows'],
                    max(float((a - b).abs().max()) for a, b in zip(k2, t2)))
                del t1, t1_64, t2
            for kname, row in rows:
                if k in (0, mesh.size - 1) or not row.ok:
                    log(f'  {size} shard {k} {kname:32s} {row}')
                if not row.ok:
                    failures.append(f'{size}.{k}.{kname}.{row.output}.{row.entries}')
            log(f'  {size} shard {k}: {sum(r.ok for _, r in rows)} of {len(rows)} twin rows ok; '
                f'two launches on the same inputs equal bit for bit: {same}')
            n_in.append(n_in_cutoff((k1[1], k1[2])))
            outs1.append(k1)
            outs2.append(k2)
        # the whole row range against K1/K2 (triangular) within the same rows
        log(f'  {size}: the row kernels over all {n_pad} rows against K1/K2 (triangular):')
        whole1 = [torch.cat(x)[:n] for x in zip(*outs1)]
        del outs1
        for name, a, b, rel in (('field', whole1[0], tri1[0], check.REL_O),
                                ('s3', whole1[1][:, :n], tri1[1], check.REL_M),
                                ('s5', whole1[2][:, :n], tri1[2], check.REL_M)):
            ok, _ = rel_rows(f'fixed_field_and_scf_factors_rows {name}', a, b, rel)
            failures += [] if ok else [f'{size}.whole.{name}']
        whole2 = [torch.cat(x)[:n] for x in zip(*outs2)]
        for row in check.k2_rows((whole2[0].sum(), whole2[1], whole2[2]), tri2):
            log(f'    direct_energy_force_pot_rows vs K2 {row}')
            failures += [] if row.ok else [f'{size}.whole.k2.{row.output}']
        del outs2, whole1, whole2, tri1
        torch.cuda.empty_cache()
        # one shard's launch: time, twin, bound; K1/K2's time beside it
        lo, hi = ranges[0]
        rows_n = hi - lo
        bounds = {
            'fixed_field_and_scf_factors_rows': bound(
                n * 32 + rows_n * 12 + 2 * rows_n * n_pad * 4, n_in[0] * (OPS_TEST + OPS_K1),
                n_transcendental=n_in[0] * TRANS_K1, transcendental_rate=rate),
            'direct_energy_force_pot_rows': bound(
                n * 32 + n * 12 + rows_n * 20, n_in[0] * (OPS_TEST + OPS_K2),
                n_transcendental=n_in[0] * TRANS_K2, transcendental_rate=rate)}
        log(f'  {size}: shard 0 holds {n_in[0]} ordered in-cutoff pairs of {rows_n * n} '
            f'({n_in[0] / (rows_n * n):.4%}); all shards {sum(n_in)} (twice the unordered '
            f'pairs K1/K2 run)')
        timed = (('fixed_field_and_scf_factors_rows',
                  lambda: ED.fixed_field_and_scf_factors_rows(sites, lo, hi, consts, n_pad),
                  lambda: ED.fixed_field_and_scf_factors_rows_plain(sites, lo, hi, consts, n_pad),
                  'fixed_field_and_scf_factors',
                  lambda: ED.fixed_field_and_scf_factors(sites, consts)),
                 ('direct_energy_force_pot_rows',
                  lambda: ED.direct_energy_force_pot_rows(sites, mu, lo, hi, consts),
                  lambda: ED.direct_energy_force_pot_rows_plain(sites, mu, lo, hi, consts),
                  'direct_energy_force_pot',
                  lambda: ED.direct_energy_force_pot(sites, mu, consts)))
        for kname, kern, plain, tri, tri_call in timed:
            timing = time_kernel(torch, card, kname, kern, plain,
                                 N_TIMING if size == 'water256' else N_TIMING_TWIN_BS)
            ms, plain_ms, source = timing
            rec = kernel_record(kname, max_abs[kname], timing, bounds[kname])
            tri_ms = kernel_device_ms(tri_call, KERNELS[tri][0], N_TIMING,
                                      HELPER_KERNELS.get(tri, ())).ms
            replay_ms = graph_ms(kern, N_TIMING)
            if size == 'water256':
                record[kname] = rec
            before = ROW_MS_BEFORE[kname].get(size)
            log(f'  {size} {kname:32s} {ms:.4f} ms per launch ({rows_n} rows; ms_source '
                f'{source})'
                + ('' if before is None else f' (the earlier tile-pair design {before} ms)')
                + f', x {mesh.size} shards {ms * mesh.size:.4f} ms; bound '
                f'{bounds[kname][0]:.4f} ms ({bounds[kname][1]}), kernel / bound '
                f'{ms / bounds[kname][0]:.2f}, bound / kernel {bounds[kname][0] / ms:.1%}; twin '
                f'{plain_ms:.4f} ms; {tri} (triangular, all rows) '
                + ('not in the trace' if tri_ms is None else f'{tri_ms:.4f} ms')
                + f'; one CUDA graph replay of {N_TIMING} calls: {replay_ms:.4f} ms a call '
                f'(the wrapper\'s allocations and the gaps included)'
                + (f'; empty launch {floor}' if size == 'water256' else '')
                + f' ({card})')
        del sites, mu, tri2
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f'row kernel mismatch: {failures}')


def phase_mesh_single_point(torch, card, mesh, tag='(b)'):
    """Phase 29 (b): water256 dense under the mesh against the unmeshed
    single point, the SCF at DIIS_EPS on both sides; under 'quad_bf16' the
    2B and 3B energies compared bit for bit."""
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED

    system, pos = load_water256(torch, torch.device(mesh.lead), torch.float32)
    failures = []
    for impl in (None, 'quad_bf16'):
        cfg = MBPolConfig(**dict(SINGLE_POINT, target_epsilon=DIIS_EPS, scf_eps_floor=DIIS_EPS,
                                 pip_impl=impl))
        ref = MBPol(system, cfg, device=mesh.lead).energy_forces(pos)
        ED.reset_launch_counts()
        pot = MBPol(system, cfg, mesh=mesh)
        got = pot.energy_forces(pos)
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in ED.KERNELS + ED.ROW_KERNELS}
        log(f'  {tag} pip_impl {impl}: meshed E {float(got[0]):.6f} kJ/mol, unmeshed '
            f'{float(ref[0]):.6f}; SCF iterations {int(got[3]["iterations"])} / '
            f'{int(ref[3]["iterations"])}; launches {launches}')
        assert pot.elec_mode == 'dense' and bool(got[3]['converged'])
        assert all(launches[k] == mesh.size for k in ROW_KERNELS), launches
        assert all(k.launches == 0 for k in ED.KERNELS), launches
        d_el = abs(float(got[2]['electrostatics']) - float(ref[2]['electrostatics']))
        b_el = F32_BOUND_FACTOR * JAX_F32_DISTANCE['water256_pme']['terms']['electrostatics']
        ok = d_el <= b_el
        log(f'    electrostatics |dE| {d_el:.6e} kJ/mol (bound {b_el:.6e}) '
            f'{"ok" if ok else "FAIL"}')
        failures += [] if ok else [f'{impl}.electrostatics']
        for k in got[2]:
            if k == 'electrostatics':
                continue
            a, b = float(got[2][k]), float(ref[2][k])
            rel = abs(a - b) / max(abs(b), 1e-30)
            same = bool(torch.equal(got[2][k], ref[2][k]))
            log(f'    {k:14s} rel {rel:.3e} (bound {TERM_REL}), bits equal {same}')
            failures += [] if rel <= TERM_REL else [f'{impl}.{k}']
            if impl == 'quad_bf16' and k in ('two_body', 'three_body') and not same:
                log(f'      {k}: not bit for bit: kernel #10 gives each row the same bits, but '
                    f'the energy is the sum of {mesh.size} per-shard sums, added on the lead in '
                    f'shard order, where the unmeshed path sums the whole batch at once')
        f_rel = float((got[1] - ref[1]).abs().max() / ref[1].abs().max())
        log(f'    forces max |dF| / max |F| {f_rel:.3e} (bound {REPLICA_F_WHOLE})')
        failures += [] if f_rel <= REPLICA_F_WHOLE else [f'{impl}.forces']
    if failures:
        raise AssertionError(f'meshed single point: {failures}')


def phase_mesh_block(torch, card, mesh):
    """Phase 29 (c): water4096 block under the mesh: each shard's kernels
    against their twins on its local list, the per-shard tile pairs, and
    the single point against the unmeshed block one."""
    from mbpol_openmm_plugin_tpu_torch.models import electrostatics as elec
    from mbpol_openmm_plugin_tpu_torch.models import pme
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as BS
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_check as check

    big, pos = load_water4096(torch)
    cfg = MBPolConfig(**dict(SINGLE_POINT, electrostatics_mode='block', dispersion_mode='pairs'))
    ref_pot = MBPol(big, cfg).tune_capacities(pos)
    pot = MBPol(big, cfg, mesh=mesh).tune_capacities(pos)
    block, params = pot._block_info, pot.elec_params
    charges, _ = elec.assemble_charges(params, pos)
    sites, tiles = pme.block_sites(params, pot.pme, pos, charges, block, mesh=mesh)
    n, consts = pos.shape[0], ED.DirectConsts.from_setup(pot.pme, params.thole)
    polarity = torch.as_tensor(params.polarity[block['site_perm']], dtype=pos.dtype,
                               device=pos.device)
    field, _ = BS.fixed_field_and_scf_lines_sharded(sites, n, tiles, consts,
                                                    block['line_capacity'], mesh)
    mu = (polarity[:, None] * field).contiguous()
    log(f'  sorted sites {tuple(sites.shape)}, {sites.shape[0] // BS.TILE} row tiles, '
        f'{tiles[0].n_row_tiles} per shard; local list capacity '
        f'{block["tile_pair_capacity_local"]} (global {block["tile_pair_capacity"]}); active '
        f'pairs per shard {[int(t.n_act) for t in tiles]}')
    failures = []
    for k, t in enumerate(tiles):
        assert 0 < int(t.n_act) <= t.capacity, (k, int(t.n_act), t.capacity)
        checks = check.block_kernel_rows(sites, polarity, t, n, consts, block['line_capacity'],
                                         mu=mu)
        bad = [f'{kn}.{r.output}.{r.entries}' for kn, (rows, _) in checks.items()
               for r in rows if not r.ok]
        log(f'  shard {k}: rows {t.row_tile0 * BS.TILE}..{(t.row_tile0 + t.n_row_tiles) * BS.TILE}'
            f', K1-bs/K3-bs/K2-bs twin rows ok: {not bad}; max |kernel - twin| '
            f'{ {kn: f"{v[1]:.2e}" for kn, v in checks.items()} }')
        failures += [f'shard{k}.{b}' for b in bad]
    BS.reset_launch_counts()
    got = pot.energy_forces(pos)
    launches = {k.__name__: k.launches for k in BS.KERNELS}
    ref = ref_pot.energy_forces(pos)
    torch.cuda.synchronize()
    d = got[3]
    log(f'  single point meshed {float(got[0]):.6f} / unmeshed {float(ref[0]):.6f} kJ/mol; '
        f'elec_tile_pairs {int(d["elec_tile_pairs"])} (unmeshed {int(ref[3]["elec_tile_pairs"])})'
        f', tile overflow {bool(d["elec_tile_overflow"])}, line overflow '
        f'{bool(d["elec_line_overflow"])}; block launches {launches}')
    assert not bool(d['elec_tile_overflow']) and not bool(d['elec_line_overflow'])
    assert int(d['elec_tile_pairs']) == int(ref[3]['elec_tile_pairs'])
    assert all(v >= mesh.size for v in launches.values()), launches
    e_rel = abs(float(got[0]) - float(ref[0])) / abs(float(ref[0]))
    f_rel = float((got[1] - ref[1]).abs().max() / ref[1].abs().max())
    same = {k: bool(torch.equal(got[2][k], ref[2][k])) for k in ref[2]}
    log(f'    energy rel {e_rel:.3e} (bound {REPLICA_E_REL}), forces {f_rel:.3e} (bound '
        f'{REPLICA_F_WHOLE}); per-term bits equal {same}, forces bits equal '
        f'{bool(torch.equal(got[1], ref[1]))} (the PME grid is the sum of {mesh.size} partial '
        f'grids, and each term the sum of per-shard sums)')
    failures += [] if e_rel <= REPLICA_E_REL and f_rel <= REPLICA_F_WHOLE else ['single_point']
    if failures:
        raise AssertionError(f'meshed block path: {failures}')


def phase_mesh_md(torch, card, record, mesh, classical_rate):
    """Phase 29 (d): water256 dense MD under the mesh, captured: phase 5's
    gate, the row kernels once per shard and step; the main path of the
    row kernels' launch counts."""
    from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED

    system, pos = load_water256(torch, torch.device(mesh.lead), torch.float32)
    pot = MBPol(system, MBPolConfig.for_dynamics(), mesh=mesh)
    sim = Simulation(pot, SimulationConfig(dt=0.0002, nlist_rebuild_interval='auto'))
    assert sim.captured
    sim.set_positions(pos)
    torch.cuda.synchronize()
    ED.reset_launch_counts()
    t0 = time.perf_counter()
    out = sim.step(MESH_MD_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in ED.KERNELS + ED.ROW_KERNELS}
    e_tot = out['step_total_energy']
    fit = second_half_fit(e_tot)
    rate = MESH_MD_STEPS / wall
    log(f'  {MESH_MD_STEPS} captured steps, {mesh.size} shards on {mesh.lead}: E_tot '
        f'{e_tot[0]:.4f} -> {e_tot[-1]:.4f} kJ/mol, second-half fit {fit:+.4f} (bound '
        f'{MD_FIT_TOL_KJ}); {rate:.2f} steps/s beside phase 5\'s {classical_rate:.2f} ({card}); '
        f'capture {sim.capture_ms[0]:.1f} ms; launches {launches}, row kernels per step '
        f'{[launches[k] / MESH_MD_STEPS for k in ROW_KERNELS]}')
    assert np.all(np.isfinite(e_tot)) and abs(fit) <= MD_FIT_TOL_KJ, fit
    assert all(launches[k] >= mesh.size * MESH_MD_STEPS for k in ROW_KERNELS), launches
    assert all(k.launches == 0 for k in ED.KERNELS), launches
    for k in ROW_KERNELS:
        record[k]['launches'] = launches[k]
    # the same steps from one state, eager and captured (phase 19's check)
    runs = []
    for eager in (True, False):
        s2 = Simulation(pot, SimulationConfig(dt=0.0002, nlist_rebuild_interval='auto'),
                        _eager=eager)
        s2.set_positions(sim.state.positions)
        s2.state = dataclasses.replace(s2.state, velocities=sim.state.velocities.clone())
        runs.append((s2, s2.step(MESH_EAGER_STEPS)))
    (se, oe), (sc, oc) = runs
    same = (np.array_equal(oe['step_total_energy'], oc['step_total_energy'])
            and all(bool(torch.equal(getattr(se.state, k), getattr(sc.state, k)))
                    for k in ('positions', 'velocities')))
    log(f'  {MESH_EAGER_STEPS} meshed steps eager and captured from the same state: E_tot '
        f'traces and final state equal bit for bit: {same}')
    assert same
    return rate


def phase_mesh_planned(torch, card, mesh):
    """Phase 29 (e): water4096 sparse and water8192 block through
    plan_capacities(n_devices=size), single points against the unmeshed
    ones (through a one-device plan) under the replication rows."""
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.parallel.plan import plan_capacities

    pot256 = MBPol(load_water256(torch, torch.device(mesh.lead), torch.float32)[0],
                   MBPolConfig(**SINGLE_POINT))
    failures = []
    for name, reps, mode in (('water4096', REPS, 'sparse'), ('water8192', REPS8192, 'block')):
        system, pos = load_replicated(torch, reps)
        grid = tuple(g * r for g, r in zip(pot256.pme.grid, reps))
        cfg = MBPolConfig(**dict(SINGLE_POINT, pme_grid=grid, electrostatics_mode=mode))
        plans = {nd: plan_capacities(system.n_waters, system.box, n_devices=nd, config=cfg,
                                     positions=pos) for nd in (1, mesh.size)}
        plan = plans[mesh.size]
        log(f'  {name} ({mode}): plan for {mesh.size} devices: per device {plan.per_device()}, '
            f'local tile pairs {plan.tile_pair_capacity_local}, est. '
            f'{plan.mem_per_device_mb:.0f} MB/device')
        ref = MBPol(system, cfg, plan=plans[1]).energy_forces(pos)
        torch.cuda.synchronize()
        got = MBPol(system, cfg, mesh=mesh, plan=plan).energy_forces(pos)
        torch.cuda.synchronize()
        over = [k for k, v in got[3].items() if k.endswith('_overflow') and bool(v)]
        e_rel = abs(float(got[0]) - float(ref[0])) / abs(float(ref[0]))
        f_rel = float((got[1] - ref[1]).abs().max() / ref[1].abs().max())
        log(f'    meshed {float(got[0]):.4f} / unmeshed {float(ref[0]):.4f} kJ/mol: energy rel '
            f'{e_rel:.3e} (bound {REPLICA_E_REL}), forces {f_rel:.3e} (bound {REPLICA_F_WHOLE})'
            f'; overflow {over or "none"}; converged {bool(got[3]["converged"])}')
        if over or not bool(got[3]['converged']) or e_rel > REPLICA_E_REL \
                or f_rel > REPLICA_F_WHOLE:
            failures.append(name)
        del system, pos, ref, got
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f'planned meshed single points: {failures}')


def phase_mesh_pimd_remd(torch, card, mesh):
    """Phase 29 (f): 8 full beads over the shards and the water14 REMD ladder
    over them, each bit for bit the unmeshed run."""
    from mbpol_openmm_plugin_tpu_torch.md import remd
    from mbpol_openmm_plugin_tpu_torch.md.rpmd import PIMDSimulation
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig

    pot, pos = pimd_potential(torch)
    runs = []
    for m in (None, mesh):
        sim = PIMDSimulation(pot, n_beads=PIMD_BEADS, dt=PIMD_DT, temperature=300.0,
                             thermostat='none', seed=0, nlist_rebuild_interval=PIMD_NL_EVERY,
                             mesh=m)
        assert sim.captured
        sim.set_positions(pos, spread=PIMD_SPREAD)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sim.step(MESH_PIMD_STEPS)
        torch.cuda.synchronize()
        runs.append((out, sim.state, time.perf_counter() - t0))
    (a, sa, wa), (b, sb, wb) = runs
    same = (np.array_equal(a['step_hamiltonian'], b['step_hamiltonian'])
            and all(bool(torch.equal(getattr(sa, k), getattr(sb, k)))
                    for k in ('positions', 'velocities', 'forces', 'potential_energy')))
    log(f'  PIMD {PIMD_BEADS} full beads, {PIMD_BEADS // mesh.size} per shard, '
        f'{MESH_PIMD_STEPS} captured steps: meshed equal to unmeshed bit for bit: {same}; '
        f'{MESH_PIMD_STEPS / wa:.2f} / {MESH_PIMD_STEPS / wb:.2f} steps/s (capture included) '
        f'({card})')
    assert same
    del pot
    system, pos, _ = cluster_input(torch, 'water14_cluster')
    pot = MBPol(system, MBPolConfig(**WATER14_MD))
    temps = remd.geometric_ladder(180.0, 480.0, MESH_REMD_R)
    ladders = []
    for m in (None, mesh):
        sim = remd.REMDSimulation(pot, temps, remd.REMDConfig(dt=2e-4,
                                                              exchange_interval=MESH_REMD_INTERVAL),
                                  seed=0, mesh=m)
        sim.set_positions(pos)
        sim.set_velocities_to_temperature()
        out = sim.run(1)
        ladders.append((out, sim.state))
    (a, sa), (b, sb) = ladders
    same = (all(np.array_equal(a[k], b[k]) for k in ('walker', 'accept', 'potential_energy'))
            and bool(torch.equal(sa.positions, sb.positions)))
    log(f'  REMD water14, R = {MESH_REMD_R} over {mesh.size} shards, one block of '
        f'{MESH_REMD_INTERVAL} steps: walkers {b["walker"][0].tolist()}, accepts '
        f'{b["accept"][0].tolist()}; equal to the unmeshed ladder bit for bit: {same}')
    assert same


def phase_mesh(torch, card, record, classical_rate):
    """Phase 29: the device mesh on the one card ((a)-(f)); on a machine
    with more cards, (b) also over distinct cards."""
    count = torch.cuda.device_count()
    mesh = card_mesh(torch)
    log(f'  mesh: {mesh.size} shards on {mesh.distinct()}; torch.cuda.device_count() {count}')
    steps = {}
    for tag, fn in (('(a) row kernels #3/#4 vs twins', lambda: phase_mesh_kernels(
                        torch, card, record, mesh)),
                    ('(b) water256 dense single point', lambda: phase_mesh_single_point(
                        torch, card, mesh)),
                    ('(c) water4096 block', lambda: phase_mesh_block(torch, card, mesh)),
                    ('(d) water256 dense MD', lambda: phase_mesh_md(torch, card, record, mesh,
                                                                    classical_rate)),
                    ('(e) planned water4096 sparse and water8192 block', lambda: phase_mesh_planned(
                        torch, card, mesh)),
                    ('(f) PIMD and REMD', lambda: phase_mesh_pimd_remd(torch, card, mesh))):
        log(f'  {tag}')
        t0 = time.perf_counter()
        fn()
        steps[tag[:3]] = time.perf_counter() - t0
    if count > 1:
        multi = card_mesh(torch, devices=[torch.device('cuda', k) for k in range(min(count, 4))])
        log(f'  (b) over {multi.size} distinct cards {multi.devices}')
        phase_mesh_single_point(torch, card, multi, tag='(b, cards)')
    else:
        log('  (b) over distinct cards: not run (one card visible)')
    log(f'  phase 29 walls: {", ".join(f"{k} {v:.1f} s" for k, v in steps.items())}')


# phase 30: the example applications; the depths cut for the smoke run
EXAMPLE_STEPS = {'bulk_properties': 400, 'ir_spectrum': 100, 'isotope_density': 100,
                 'water256_pimd': 20, 'water14_pimd': 10, 'remd_blocks': 2, 'remd_warm': 0,
                 'app_production': 100, 'water14_minimize': 20}
EXAMPLE_BULK = dict(npt_eq_ps=0.0, npt_ps=0.5, nve_ps=0.2)
EXAMPLE_RESPA = dict(steps=50, therm=0, seg=25)
EXAMPLE_MODES = ('dense', 'block', 'sparse')
# water14_pimd steps read under torch.profiler for its eager breakdown (its
# trace of ~32,000 kernels and their host ops a step takes ~20 s to read)
EAGER_BREAKDOWN_STEPS = 1


def all_launches():
    """{wrapper: launches} of every kernel wrapper."""
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as BS
    from mbpol_openmm_plugin_tpu_torch.ops import pip_fused as PF
    return {k.__name__: k.launches for k in ED.KERNELS + ED.ROW_KERNELS + BS.KERNELS
            + PF.KERNELS}


def reset_all_launches():
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as BS
    from mbpol_openmm_plugin_tpu_torch.ops import pip_fused as PF
    for mod in (ED, BS, PF):
        mod.reset_launch_counts()


def example_run(walls, tag, fn, need=()):
    """fn() with every launch count set to 0 before and read after; the
    kernels in `need` must have launched. Returns fn's result."""
    reset_all_launches()
    t0 = time.perf_counter()
    out = fn()
    walls[tag] = time.perf_counter() - t0
    got = {k: v for k, v in all_launches().items() if v}
    log(f'  [{tag}] {walls[tag]:.1f} s; launches {got}')
    missing = [k for k in need if not got.get(k)]
    assert not missing, f'{tag}: kernels of its path not launched: {missing}'
    return out


def eager_breakdown(torch, fn):
    """(device-busy ms, device kernels, host reads, stream or device
    synchronizes) of one fn() under torch.profiler (CPU and CUDA activity):
    the busy time sums the CUDA kernels' self time, a host read is an
    aten::_local_scalar_dense (.item(), float(), bool() of a card tensor)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy_us, kernels, reads, syncs = 0.0, 0, 0, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            busy_us += ev.self_device_time_total
            kernels += ev.count
        elif ev.key == 'aten::_local_scalar_dense':
            reads += ev.count
        elif ev.key in ('cudaStreamSynchronize', 'cudaDeviceSynchronize'):
            syncs += ev.count
    return busy_us / 1e3, kernels, reads, syncs


def finite(*xs):
    return all(np.all(np.isfinite(np.asarray(x, np.float64))) for x in xs)


def phase_examples(torch, card):
    """Phase 30: the example applications and the two validation tools."""
    import tempfile

    from mbpol_openmm_plugin_tpu_torch.examples import (bulk_properties, example_nvt_nve,
                                                        ir_spectrum, isotope_density,
                                                        make_inputs, multichip_scaling,
                                                        remd_water14, water14, water14_pimd,
                                                        water256_pimd, water2048_scaling)
    from mbpol_openmm_plugin_tpu_torch.tools import bulk_validation, respa_drift
    k12 = ('fixed_field_and_scf_factors', 'direct_energy_force_pot')
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = example_run(walls, 'make_inputs', lambda: make_inputs.run(tmp, echo=False))
        assert all(os.path.getsize(p) > 0 for p in paths.values())
        out = example_run(walls, 'water14', lambda: water14.run(
            min_iterations=EXAMPLE_STEPS['water14_minimize'], pdb_dir=tmp, echo=False))
        assert finite(out['potential_energy_kcal'], out['forces_kcal_per_A'],
                      out['final_pe_kcal']) and out['minimized_kcal'] < out['potential_energy_kcal']
        log(f"  water14 app: single point {out['potential_energy_kcal']:.4f} kcal/mol, "
            f"minimized ({EXAMPLE_STEPS['water14_minimize']} iterations) "
            f"{out['minimized_kcal']:.4f}, after 100 NVE steps "
            f"{out['final_pe_kcal']:.4f}")
        n = EXAMPLE_STEPS['app_production']
        out = example_run(walls, 'example_nvt_nve', lambda: example_nvt_nve.run(
            n, log_dir=tmp, pdb_dir=tmp, echo=False), k12)
        rows = {}
        for k, path in out['logs'].items():
            with open(path) as fh:
                rows[k] = fh.read().splitlines()[1:]
        assert all(rows.values()) and finite(out['nvt_pe_ke'], out['nve_pe_ke']), rows
        assert not any('nan' in line.lower() for r in rows.values() for line in r), rows
        log(f"  example_nvt_nve: NVT PE/KE {out['nvt_pe_ke']}, NVE {out['nve_pe_ke']} kJ/mol; "
            f"log rows {[len(r) for r in rows.values()]}")

    n = EXAMPLE_STEPS['bulk_properties']
    bp = example_run(walls, 'bulk_properties', lambda: bulk_properties.run(
        n, check_health=True, edge_probe=True, echo=False), k12)
    lo_r, hi_r = bulk_validation.BANDS['g_oo_peak_r']
    lo_h, hi_h = bulk_validation.BANDS['g_oo_peak_h']
    assert finite(bp['rdf_g'], bp['sq_s'], bp['hbonds_per_molecule'], bp['tetrahedral_order'],
                  bp['msd'], bp['gk_d'], bp['dipoles'], bp['epsilon'], bp['vdos'])
    d = bp['d_einstein_nm2_ps']
    log(f"  bulk_properties {n}: g_OO peak {bp['g_oo_peak_nm']:.4f} nm, height "
        f"{bp['g_oo_peak_height']:.3f} (bands {lo_r}-{hi_r}, {lo_h}-{hi_h}); S(q) peak "
        f"{bp['sq_peak']:.3f} at {bp['sq_peak_q']:.2f} 1/nm; H-bonds/molecule "
        f"{bp['hbonds_per_molecule']:.3f}; q_tet {bp['tetrahedral_order']:.4f}; D Einstein "
        f"{'too short' if d is None else f'{d:.4e} nm^2/ps'}, GK at t_max "
        f"{bp['d_gk_last_nm2_ps']:.4e}; epsilon {bp['epsilon']:.2f} from "
        f"{len(bp['dipoles'])} dipoles; VDOS peaks {bp['vdos_peaks']}")
    log(f"  bulk_properties steps/s: Langevin {bp['eq_steps_per_second']:.2f}, NVE in calls "
        f"of {bulk_properties.FRAME_EVERY} {bp['production_steps_per_second']:.2f}, as one "
        f"chunk {bp['one_chunk_steps_per_second']:.2f}: report edges "
        f"{100 * bp['edge_share']:.1f}% of the production wall; analysis "
        f"{bp['analysis_s']:.1f} s; captured {bp['captured']} ({card})")
    assert lo_r <= bp['g_oo_peak_nm'] <= hi_r and lo_h <= bp['g_oo_peak_height'] <= hi_h

    n = EXAMPLE_STEPS['ir_spectrum']
    ir = example_run(walls, 'ir_spectrum', lambda: ir_spectrum.run(
        n, check_health=True, edge_probe=True, echo=False))
    assert finite(ir['dipoles']) and ir['n_frames'] == n // ir_spectrum.FRAME_EVERY
    log(f"  ir_spectrum {n}: {ir['n_frames']} frames, resolution "
        f"{ir['resolution_invcm']:.0f} 1/cm, band peaks {ir['bands']}; steps/s Langevin "
        f"{ir['eq_steps_per_second']:.2f}, NVE in calls of {ir_spectrum.FRAME_EVERY} "
        f"{ir['production_steps_per_second']:.2f}, as one chunk "
        f"{ir['one_chunk_steps_per_second']:.2f}: report edges {100 * ir['edge_share']:.1f}% "
        f"({card})")

    n = EXAMPLE_STEPS['isotope_density']
    iso = example_run(walls, 'isotope_density', lambda: isotope_density.run(
        n, 8, 25, device='cuda', echo=False), k12)
    for name in ('H2O', 'D2O'):
        r = iso[name]
        assert finite(r['rho'], r['volumes'], r['ke_virial_kj']) and r['moves_attempted'] >= 1, r
        log(f"  isotope_density {name} 8 -> 1: rho {r['rho']:.5f} +- {r['rho_err']:.5f} g/cm^3, "
            f"moves {r['moves_accepted']}/{r['moves_attempted']}, KE_cv "
            f"{r['ke_virial_kj']:.1f} kJ/mol, captured {r['captured']} ({r['captures']} captures)")
    log(f"  isotope_density ratio rho(D2O)/rho(H2O) {iso['ratio']:.5f} (mass ratio "
        f"{iso['mass_ratio']:.5f}; molar-volume effect {100 * iso['molar_volume_effect']:+.3f}%; "
        f"{n} steps, not converged)")

    n = EXAMPLE_STEPS['water256_pimd']
    wp = example_run(walls, 'water256_pimd', lambda: water256_pimd.run(n, echo=False), k12)
    for k in ('classical', 'rpc'):
        r = wp[k]
        assert finite(r['pe_last'], r['ke_virial_kcal'])
        log(f"  water256_pimd {k}: {r['steps_per_second']:.2f} steps/s ({r['ms_per_step']:.2f} "
            f"ms/step), KE_virial {r['ke_virial_kcal']:.1f} kcal/mol against 3/2 NkT "
            f"{r['classical_kcal']:.1f} ({card})")
    n = EXAMPLE_STEPS['water14_pimd']
    w14 = example_run(walls, 'water14_pimd', lambda: water14_pimd.run(8, n, echo=False))
    assert finite(w14['ke_virial'], w14['pe_bead_mean_kcal'])
    log(f"  water14_pimd 8 beads: {w14['steps_per_second']:.2f} steps/s, KE_q "
        f"{w14['ke_q_kcal']:.2f} kcal/mol against 3/2 NkT {w14['ke_classical_kcal']:.2f} "
        f"(ratio {w14['ratio']:.2f}) ({card})")
    # where its step's time goes: the eager loop's device-busy time and host
    # reads per step (not gated; an empty trace reads 'not measured')
    sys14, pot14, pos14 = water14_pimd.potential('cuda')
    normal = water256_pimd.generator_normals(pot14.device)
    step14, st14 = water14_pimd.start(pot14, pos14, 8, 0, normal)
    st14 = water256_pimd.trajectory(sys14, step14, st14, 1, water14_pimd.T, normal)[0]
    n = EAGER_BREAKDOWN_STEPS
    busy, kernels, reads, syncs = eager_breakdown(torch, lambda: water256_pimd.trajectory(
        sys14, step14, st14, n, water14_pimd.T, normal))
    wall_ms = 1e3 / w14['steps_per_second']
    if kernels:
        log(f"  water14_pimd eager step ({n} steps under torch.profiler): device busy "
            f"{busy / n:.2f} ms of the unprofiled {wall_ms:.2f} ms wall ({busy / n / wall_ms:.1%}), "
            f"{kernels / n:.0f} kernels, {reads / n:.0f} host reads, {syncs / n:.0f} "
            f"synchronizes a step ({card})")
    else:
        log('  water14_pimd eager step: not measured (the profiler trace holds no kernel)')

    nb = EXAMPLE_STEPS['remd_blocks']
    for mesh in (False, True):
        tag = 'remd_water14' + (' --mesh' if mesh else '')
        rm = example_run(walls, tag, lambda: remd_water14.run(
            nb, 4, mesh, warm_blocks=EXAMPLE_STEPS['remd_warm'], echo=False))
        assert finite(rm['mbar_f'], [g[1:] for g in rm['mbar_grid']], rm['u_kn'])
        log(f"  {tag}: {rm['replica_steps_per_second']:.1f} replica-steps/s, acceptance "
            f"{np.round(rm['out']['acceptance'], 2).tolist()}, MBAR f "
            f"{np.round(rm['mbar_f'], 3).tolist()}, shards {rm['mesh_shards']} ({card})")

    sys2048, pos2048, _ = water2048_scaling.system_and_positions(2048)
    modes = {}
    for mode in EXAMPLE_MODES:
        need = {'dense': k12, 'block': ('fixed_field_and_scf_lines', 'scf_dipole_field_bs',
                                        'direct_energy_force_pot_bs')}.get(mode, ())
        modes[mode] = r = example_run(walls, f'water2048_scaling {mode}', lambda: (
            water2048_scaling.mode_run(sys2048, pos2048, mode, echo=False)), need)
        assert r['mode'] == mode and r['converged'] and not any(r['overflow'].values()), r
        log(f"  water2048 {mode}: E {r['energy'] / 4.184:.3f} kcal/mol ({r['iterations']} SCF "
            f"iterations), first evaluation {r['first_eval_s']:.2f} s, warm evaluation "
            f"{r['warm_eval_ms']:.2f} ms, peak {r.get('peak_gib', float('nan')):.2f} GiB ({card})")
        torch.cuda.empty_cache()
    ref = modes['dense']
    for mode in EXAMPLE_MODES[1:]:
        de = abs(modes[mode]['energy'] - ref['energy']) / abs(ref['energy'])
        df = float(np.max(np.abs(modes[mode]['forces'] - ref['forces']))
                   / np.max(np.abs(ref['forces'])))
        log(f'  water2048 {mode} vs dense: energy {de:.3e} relative (bound {REPLICA_E_REL}), '
            f'forces {df:.3e} of max|F| (bound {REPLICA_F_WHOLE})')
        assert de <= REPLICA_E_REL and df <= REPLICA_F_WHOLE

    mc = example_run(walls, 'multichip_scaling', lambda: multichip_scaling.run(2048, 4,
                                                                              echo=False))
    plan = mc['plan']
    need = (('fixed_field_and_scf_factors_rows', 'direct_energy_force_pot_rows')
            if plan.elec_mode == 'dense' else ())
    assert not [k for k in need if not all_launches()[k]], 'row kernels not launched'
    assert mc['converged'] and not mc['overflow'] and mc['md_finite']
    log(f"  multichip_scaling 2048 on {mc['mesh_shards']} shards of {mc['mesh_devices']}: "
        f"mode {plan.elec_mode}, E {mc['energy'] / 4.184:.3f} kcal/mol, first evaluation "
        f"{mc['first_eval_s']:.2f} s, Verlet {mc['md_ms_per_step']:.1f} ms/step, plan "
        f"{plan.mem_per_device_mb:.0f} MB/device ({card})")
    torch.cuda.empty_cache()

    bv = example_run(walls, 'bulk_validation', lambda: bulk_validation.run(
        device='cuda', check_health=True, echo=False, **EXAMPLE_BULK), k12)
    log('  bulk_validation ' + json.dumps(bv))
    assert bv['band_ok']['g_oo_peak_r'] and bv['band_ok']['g_oo_peak_h'], bv['band_ok']
    rd = example_run(walls, 'respa_drift', lambda: respa_drift.run(
        device='cuda', check_health=True, echo=False, **EXAMPLE_RESPA), k12)
    assert not rd['nan'] and finite(rd['series'])
    log(f"  respa_drift (mid 3, inner 2, {EXAMPLE_RESPA}): drift {rd['drift_K_per_ns']:.1f} "
        f"K/ns over {rd['window_ps']:.3f} ps, {rd['outer_steps_per_second']:.2f} outer steps/s "
        f"({card})")
    log(f'  phase 30 walls: {", ".join(f"{k} {v:.1f} s" for k, v in walls.items())}')


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
    block_rate = phase_md4096(torch, card, record, pot4096, pos4096)
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
    begin_phase(f'== phase 24: app layer and builder (the {len(APP_RUNS)} example INIs on the card; '
                f'the per-force API, with_updated_params)')
    phase_app(torch, card, quad_steps_per_s)
    begin_phase(f'== phase 25: sparse electrostatics (water256 vs dense; water4096 vs water256 x '
                f'{N_COPIES}; {SPARSE_MD_STEPS} captured water4096 steps)')
    phase_sparse(torch, card, pot256, e256, f256, parts256, block_rate)
    begin_phase('== phase 26: list compaction and the reference triplets (water256 dense, K1/K2, '
                'kernel #10 on the compacted batches)')
    phase_compact(torch, card, record, quad_steps_per_s)
    begin_phase(f'== phase 27: water8192 (planner, block kernels, chunked PME grid, '
                f'{MD8192_STEPS} captured steps)')
    phase_water8192(torch, card)
    begin_phase(f'== phase 28: compensated accumulation (the drift tool, water256, {DRIFT_STEPS} '
                f'steps plain and --kahan)')
    phase_drift(torch, card)
    begin_phase(f'== phase 29: the device mesh ({MESH_SHARDS} shards on cuda:0: row kernels, '
                f'dense, block, sparse, planned, MD, PIMD, REMD)')
    phase_mesh(torch, card, record, quad_steps_per_s)
    begin_phase('== phase 30: the example applications and the validation tools (the port\'s '
                'examples/, tools/bulk_validation.py, tools/respa_drift.py)')
    phase_examples(torch, card)
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
