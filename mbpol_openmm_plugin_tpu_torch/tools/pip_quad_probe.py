"""The four fused PIP kernels of csrc/pip_fused.cu alone, on one CUDA card:
a short build-check-time run (chip_smoke.py phase 9 holds them too, after
eight other phases; this takes ~40 s).

    python -m mbpol_openmm_plugin_tpu_torch.tools.pip_quad_probe [--reps 20]
        [--impl pallas quad_pallas quad_bf16 vech_pallas]

Builds the kernels, prints the compiler's resource lines (registers,
spills) of the four kernels and how many blocks of each the card keeps
resident per SM, then for each kernel (--impl: MBPolConfig.pip_impl values,
default all four) and for poly2b and poly3b:
  - the checks of ops/pip_fused_check.py against the plain twin on the
    water256 lists' variables (with the energy error summed over the rows,
    kernel and float32 twin against the float64 twin: what a term's total
    feels) and on 4096 seeded rows, and bit-identity of
    ragged batches (1, 63, 64, 65, 129 rows) to the same rows of a run of
    33,801 rows (above two waves of blocks of the quadratic forms);
  - the time per call of the kernel, its twin and the library evaluator of
    the same function (the cuBLAS float32 ops/polyeval
    .pip_quad_energy_and_grad; for the monomial kernel
    .pip_energy_and_grad), back to back between CUDA events, and the
    kernel's effective rate: TFLOP/s (2 P B^2 over its time) for the
    quadratic forms, monomials per second and their share of the
    transcendental unit's peak (16 results per clock per SM at the card's
    maximum SM clock) for the monomial kernel.
Exits non-zero when a check fails. Prints the card's name and power limit
and one JSON object as the last line.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch.tools.timing import (MUFU_PER_CLOCK_PER_SM, card_line, loop_ms,
                                                        max_sm_clock_hz)

RAGGED = (1, 63, 64, 65, 129, 33801)
KERNEL_NAMES = {'pallas': 'pip_monomial_kernel', 'quad_pallas': 'pip_quad_explog_kernel',
                'quad_bf16': 'pip_quad_product_kernel', 'vech_pallas': 'pip_quad_vech_kernel'}


def resource_lines(build_log, kernels):
    """{kernel: 'N registers, ... spill ...'} from nvcc's -Xptxas -v report
    (the resource lines follow the line that names the entry function)."""
    found, name = {}, None
    for line in build_log.splitlines():
        if 'Compiling entry function' in line:
            name = next((k for k in kernels if k in line), None)
        elif name and ('registers' in line or 'spill' in line):
            found[name] = (found.get(name, '') + ' ' + line.strip()).strip()
    return found


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--reps', type=int, default=20)
    ap.add_argument('--impl', nargs='+', default=list(KERNEL_NAMES), choices=list(KERNEL_NAMES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('pip_quad_probe needs a CUDA card')
    import mbpol_openmm_plugin_tpu_torch  # noqa: F401  (precision switches)
    from mbpol_openmm_plugin_tpu_torch.ops import _build, pip_fused, pip_fused_check, polyeval
    from mbpol_openmm_plugin_tpu_torch.tools.pip_split_accuracy import water256_variables

    card = card_line()
    _build.build()
    for line in _build.build_log().splitlines():
        if 'warning' in line.lower():
            print(line.strip()[:200])
    props = torch.cuda.get_device_properties(0)
    n_sms, clock = props.multi_processor_count, max_sm_clock_hz()
    for kernel, line in resource_lines(_build.build_log(), KERNEL_NAMES.values()).items():
        print(f'{kernel:26s} {line}')
    print(f'resident blocks per SM: quadratic forms {pip_fused.QUAD_BLOCKS_PER_SM}, monomial '
          f'{pip_fused.MONO_BLOCKS_PER_SM} (launch bounds; {n_sms} SMs, maximum SM clock '
          f'{clock / 1e6:.0f} MHz)')

    dev = torch.device('cuda')
    real = water256_variables(dev)
    failures, out = [], dict(card=card, rows=[])
    for impl in args.impl:
        wrapper = pip_fused.WRAPPERS[impl]
        kname = wrapper.__name__
        monomial = impl == 'pallas'
        library = polyeval.pip_energy_and_grad if monomial else polyeval.pip_quad_energy_and_grad
        for poly, x in real.items():
            p, v = x.shape
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
                if what == 'water256':
                    plain = pip_fused.PLAIN[wrapper]
                    e64 = plain(poly, xs.double())[0]
                    sums = [float((fn(poly, xs)[0].double() - e64).sum())
                            for fn in (wrapper, plain)]
                    print(f'{kname:30s} {poly} {what:8s} [{xs.shape[0]:5d}] sum over the rows of '
                          f'e - e(float64 twin): kernel {sums[0]:+.4f}, float32 twin '
                          f'{sums[1]:+.4f} (sum |e| {float(e64.abs().sum()):.1f})')
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
            lib = loop_ms(lambda: library(x, poly), args.reps)
            row = dict(kernel=kname, poly=poly, p=p, ms=ms, twin_ms=twin, library_ms=lib)
            if monomial:
                rate = p * polyeval.load_pip(poly).nmono / (ms * 1e-3)
                row.update(monomials_per_s=rate,
                           transcendental_share=rate / (MUFU_PER_CLOCK_PER_SM * n_sms * clock))
                eff = (f'{rate / 1e12:.3f} T monomials/s, {row["transcendental_share"]:.1%} of '
                       f'the transcendental peak')
            else:
                b = polyeval.load_quad(poly)[0].shape[0]
                row.update(effective_tflops=2.0 * p * b * b / (ms * 1e-3) / 1e12)
                eff = f'{row["effective_tflops"]:.1f} TFLOP/s effective'
            print(f'{kname:30s} {poly} [{p}, {v}]: kernel {ms:.4f} ms, twin {twin:.4f} ms, '
                  f'{library.__name__} {lib:.4f} ms, kernel / library {ms / lib:.3f}, {eff} '
                  f'({card})')
            out['rows'].append(row)
    out['failures'] = failures
    print(card)
    print(json.dumps(out))
    return 1 if failures else 0


if __name__ == '__main__':
    sys.exit(main())
