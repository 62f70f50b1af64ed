"""The two tensor-core quadratic-form kernels alone, on one CUDA card: a
short build-check-time run (chip_smoke.py phase 9 holds all four PIP
kernels; this takes ~20 s).

    python -m mbpol_openmm_plugin_tpu_torch.tools.pip_quad_probe [--reps 20]

Builds the kernels, prints the compiler's resource lines for
pip_quad_explog_kernel / pip_quad_product_kernel, then for each of the two
and for poly2b and poly3b:
  - the checks of ops/pip_fused_check.py against the plain twin on the
    water256 lists' variables and on 4096 seeded rows, and bit-identity of
    ragged batches (1, 63, 64, 65, 129 rows) to the same rows of a run of
    33,801 rows (above two waves of blocks);
  - the time per call of the kernel, its twin and the cuBLAS float32
    evaluator (ops/polyeval.pip_quad_energy_and_grad), back to back between
    CUDA events, and the kernel's effective TFLOP/s (2 P B^2 over its time).
Exits non-zero when a check fails. Prints the card's name and power limit
and one JSON object as the last line.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

RAGGED = (1, 63, 64, 65, 129, 33801)


def loop_ms(fn, n):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('pip_quad_probe needs a CUDA card')
    import mbpol_openmm_plugin_tpu_torch  # noqa: F401  (precision switches)
    from mbpol_openmm_plugin_tpu_torch.ops import _build, pip_fused, pip_fused_check, polyeval
    from mbpol_openmm_plugin_tpu_torch.tools.pip_split_accuracy import water256_variables
    from mbpol_openmm_plugin_tpu_torch.tools.step_breakdown import card_line

    card = card_line()
    _build.build()
    for line in _build.build_log().splitlines():
        if 'warning' in line.lower():
            print(line.strip()[:200])
    keep = False
    for line in _build.build_log().splitlines():       # the resource line follows the name
        if 'Compiling entry function' in line:
            keep = 'pip_quad_explog' in line or 'pip_quad_product' in line
            if keep:
                print(line.strip()[:120])
        elif keep and ('registers' in line or 'spill' in line):
            print('  ' + line.strip())

    dev = torch.device('cuda')
    real = water256_variables(dev)
    failures, out = [], dict(card=card, rows=[])
    for wrapper in (pip_fused.pip_quad_energy_grad, pip_fused.pip_quad_product_energy_grad):
        kname = wrapper.__name__
        for poly, x in real.items():
            p, v = x.shape
            b = polyeval.load_quad(poly)[0].shape[0]
            seeded = torch.as_tensor(np.random.default_rng(v).uniform(
                1e-4, 1.0, (max(RAGGED), v)).astype(np.float32), device=dev)
            for what, xs in (('water256', x), ('seeded', seeded[:4096].contiguous())):
                rows, _ = pip_fused_check.kernel_rows(wrapper, poly, xs,
                                                      physical=what == 'water256')
                torch.cuda.synchronize()
                for row in rows:
                    print(f'{kname:30s} {poly} {what:8s} [{xs.shape[0]:5d}] {row}')
                    if not row.ok:
                        failures.append(f'{kname}.{poly}.{what}.{row.output}.{row.measure}')
            e_all, g_all = wrapper(poly, seeded)
            for n in RAGGED:
                e_n, g_n = wrapper(poly, seeded[:n].contiguous())
                same = bool(torch.equal(e_n, e_all[:n]) and torch.equal(g_n, g_all[:n]))
                print(f'{kname:30s} {poly} ragged   [{n:5d}] same bits as in the full batch: '
                      f'{same}')
                if not same:
                    failures.append(f'{kname}.{poly}.ragged{n}')
            ms = loop_ms(lambda: wrapper(poly, x), args.reps)
            twin = loop_ms(lambda: pip_fused.PLAIN[wrapper](poly, x), 3)
            lib = loop_ms(lambda: polyeval.pip_quad_energy_and_grad(x, poly), args.reps)
            tflops = 2.0 * p * b * b / (ms * 1e-3) / 1e12
            print(f'{kname:30s} {poly} [{p}, {v}]: kernel {ms:.4f} ms, twin {twin:.4f} ms, '
                  f'cuBLAS float32 evaluator {lib:.4f} ms, kernel / library {ms / lib:.3f}, '
                  f'{tflops:.1f} TFLOP/s effective ({card})')
            out['rows'].append(dict(kernel=kname, poly=poly, p=p, ms=ms, twin_ms=twin,
                                    library_ms=lib, effective_tflops=tflops))
    out['failures'] = failures
    print(card)
    print(json.dumps(out))
    return 1 if failures else 0


if __name__ == '__main__':
    sys.exit(main())
