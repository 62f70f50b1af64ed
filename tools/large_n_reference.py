"""Reference readings behind the bounds of chip_smoke.py's phases 25 and 26
(sparse electrostatics, list compaction, the reference triplet
enumeration), through the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tools/large_n_reference.py [--what sparse compact reference]

All at the water256 fixture (tests/fixtures/water256_integration_test.npz,
positions rounded to float32, made whole, M sites placed), float32 with
x64 off and float64 inside jax.enable_x64(True):

sparse     electrostatics_mode 'sparse' against 'dense' in float32, both
           under chip_smoke.py's SINGLE_POINT configuration (PME, cutoff
           0.9 nm, target_epsilon 1e-4, nlist_skin 0.02 nm): |dE| per term
           and in total (kJ/mol), max |dF| / max |F|.
compact    compact_eval=True and 'rebuild' against no compaction in
           float32, under MBPolConfig.for_dynamics() (skin 0.02 nm) with
           target_epsilon 1e-4: the same distances.
reference  triplet_semantics='reference': the three-body energy in float32
           against float64 (kJ/mol) under SINGLE_POINT, and the triplet
           count.
closures   (float64, water50, box 1.8 nm) the JAX sparse function's SCF
           closures against the port's sparse mode, which takes the dense
           mode's closures: ASPC with aspc_n_corr=2 from a perturbed
           predictor (JAX runs one corrector whatever aspc_n_corr says) and
           'diis' (JAX runs its SOR loop): |dE|, max |d mu|, iterations.

The last line is a JSON object of the readings.
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
SINGLE_POINT = dict(nonbonded_method='PME', cutoff=0.9, target_epsilon=1e-4, nlist_skin=0.02,
                    max_iterations=200)
TERMS = ('one_body', 'two_body', 'three_body', 'dispersion', 'electrostatics')


def _evaluate(config, dtype_name):
    """(total, forces, per-term energies, diag) of the fixture, as numpy."""
    import jax
    import jax.numpy as jnp

    from mbpol_openmm_plugin_tpu.models.potential import MBPol
    from mbpol_openmm_plugin_tpu.system import (System, compute_virtual_sites,
                                                make_molecules_whole)
    with np.load(FIXTURE) as z:
        names, resnames = z['names'], z['resnames']
        pos32 = np.asarray(z['positions'], np.float32).astype(np.float64)
    with jax.enable_x64(dtype_name == 'f64'):
        dtype = jnp.float64 if dtype_name == 'f64' else jnp.float32
        system = System.from_atom_names(names, resnames, box=[BOX] * 3)
        pos = compute_virtual_sites(system, make_molecules_whole(system, jnp.asarray(pos32,
                                                                                     dtype)))
        e, f, parts, diag = MBPol(system, config).energy_forces(pos)
        return (float(e), np.asarray(f, np.float64), {k: float(v) for k, v in parts.items()},
                {k: np.asarray(v) for k, v in diag.items() if np.asarray(v).size == 1})


def _distance(a, b):
    (ea, fa, pa, _), (eb, fb, pb, _) = a, b
    out = {k: abs(pa[k] - pb[k]) for k in TERMS}
    out['total'] = abs(ea - eb)
    out['forces_rel'] = float(np.max(np.abs(fa - fb)) / np.max(np.abs(fb)))
    return out


def sparse(readings):
    from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig
    t0 = time.perf_counter()
    dense = _evaluate(MBPolConfig(electrostatics_mode='dense', **SINGLE_POINT), 'f32')
    sp = _evaluate(MBPolConfig(electrostatics_mode='sparse', **SINGLE_POINT), 'f32')
    readings['sparse_vs_dense_f32'] = _distance(sp, dense)
    readings['sparse_iterations'] = (int(sp[3]['iterations']), int(dense[3]['iterations']))
    print(f'sparse vs dense (float32): {readings["sparse_vs_dense_f32"]}, SCF iterations '
          f'{readings["sparse_iterations"]} ({time.perf_counter() - t0:.1f} s)', flush=True)


def compact(readings):
    from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig
    t0 = time.perf_counter()
    plain = _evaluate(MBPolConfig.for_dynamics(target_epsilon=1e-4), 'f32')
    for ce in (True, 'rebuild'):
        got = _evaluate(MBPolConfig.for_dynamics(target_epsilon=1e-4, compact_eval=ce), 'f32')
        key = f'compact_{ce}_vs_plain_f32'
        readings[key] = _distance(got, plain)
        readings[f'compact_{ce}_rows'] = {k: int(v) for k, v in got[3].items()
                                          if k.startswith('n_')}
        print(f'compact_eval={ce!r} vs plain (float32): {readings[key]}; rows '
              f'{readings[f"compact_{ce}_rows"]} ({time.perf_counter() - t0:.1f} s)', flush=True)


def reference(readings):
    from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig
    t0 = time.perf_counter()
    cfg = MBPolConfig(triplet_semantics='reference', **SINGLE_POINT)
    f32, f64 = _evaluate(cfg, 'f32'), _evaluate(cfg, 'f64')
    readings['reference_3b_f32_vs_f64'] = abs(f32[2]['three_body'] - f64[2]['three_body'])
    readings['reference_3b_f64'] = f64[2]['three_body']
    readings['reference_n_triplets'] = (int(f32[3]['n_triplets']), int(f64[3]['n_triplets']))
    print(f'reference semantics: three-body float32 {f32[2]["three_body"]:.6f}, float64 '
          f'{f64[2]["three_body"]:.6f} kJ/mol, |d| {readings["reference_3b_f32_vs_f64"]:.6e}; '
          f'triplets {readings["reference_n_triplets"]} ({time.perf_counter() - t0:.1f} s)',
          flush=True)


def closures(readings):
    import jax
    import jax.numpy as jnp
    import torch

    from mbpol_openmm_plugin_tpu.models import electrostatics as JE
    from mbpol_openmm_plugin_tpu.models import pme as JP
    from mbpol_openmm_plugin_tpu.models import pme_sparse as JPS
    from mbpol_openmm_plugin_tpu.ops import neighbors as JN
    from mbpol_openmm_plugin_tpu.system import System as JSystem
    from mbpol_openmm_plugin_tpu.system import compute_virtual_sites, make_molecules_whole
    from mbpol_openmm_plugin_tpu_torch.models import electrostatics as E
    from mbpol_openmm_plugin_tpu_torch.models import pme as P
    from mbpol_openmm_plugin_tpu_torch.models import pme_sparse as PS
    from mbpol_openmm_plugin_tpu_torch.system import System
    box = [1.8] * 3
    with jax.enable_x64(True), np.load(os.path.join(REPO, 'tests', 'fixtures',
                                                    'water50.npz')) as z:
        jsys = JSystem.waters(50, box=box)
        jpos = compute_virtual_sites(jsys, make_molecules_whole(jsys, jnp.asarray(
            z['positions'])))
        alpha = float(np.sqrt(-np.log(2e-4)) / 0.9)
        grid = tuple(int(np.ceil(2 * alpha * b / (3 * 1e-4 ** 0.2))) for b in box)
        js = JP.PmeSetup(alpha=alpha, grid=grid, cutoff=0.9, box=tuple(box))
        ts = P.PmeSetup(alpha=alpha, grid=grid, cutoff=0.9, box=tuple(box))
        pairs, mask, _ = JN.pair_list(jpos[jsys.o_index], box, 1.15, 2000)
        lists = (torch.as_tensor(np.array(pairs), dtype=torch.int64),
                 torch.as_tensor(np.array(mask)))
        tpos = torch.as_tensor(np.array(jpos))
        tsys = System.waters(50, box=box)
        mu_ref = JPS.pme_electrostatics_sparse(JE.ElecParams.for_system(jsys, target_epsilon=1e-8),
                                               js, jpos, pairs, mask)[2]['induced_dipoles']
        mu0 = np.array(mu_ref) * (1.0 + 0.01 * np.random.default_rng(3).standard_normal(
            mu_ref.shape))
        for name, kw, m0 in (('aspc_n_corr2', dict(scf_method='aspc', aspc_k=3, aspc_n_corr=2),
                              mu0),
                             ('diis', dict(scf_method='diis'), None)):
            kw['target_epsilon'] = 1e-8
            ej, _, dj = JPS.pme_electrostatics_sparse(
                JE.ElecParams.for_system(jsys, **kw), js, jpos, pairs, mask,
                mu0=None if m0 is None else jnp.asarray(m0))
            et, _, dt = PS.pme_electrostatics_sparse(
                E.ElecParams.for_system(tsys, **kw), ts, tpos, *lists,
                mu0=None if m0 is None else torch.as_tensor(m0))
            readings[f'closure_{name}'] = dict(
                dE=abs(float(ej) - float(et)),
                dmu=float(np.abs(np.asarray(dj['induced_dipoles'])
                                 - dt['induced_dipoles'].numpy()).max()),
                iterations=(int(dj['iterations']), int(dt['iterations'])))
            print(f'{name}: JAX sparse vs port sparse {readings[f"closure_{name}"]}', flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--what', nargs='+', default=['sparse', 'compact', 'reference'],
                    choices=['sparse', 'compact', 'reference', 'closures'])
    args = ap.parse_args(argv)
    readings = {}
    for what in args.what:
        globals()[what](readings)
    print(json.dumps(readings))


if __name__ == '__main__':
    main()
