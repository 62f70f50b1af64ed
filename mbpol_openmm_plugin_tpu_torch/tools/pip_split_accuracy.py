"""How far a tensor-core arithmetic for the quadratic-form product m2 @ W,
or for the monomial expansion's gradient contraction mc @ Et, sits from
float64, beside the plain float32 evaluation.

    python -m mbpol_openmm_plugin_tpu_torch.tools.pip_split_accuracy [--device cpu|cuda]
        [--rows N] [--what quad|monomial|all] [--monomial-rows N]

On the variables that the water256 fixture's pair and triplet lists give
the 2B and 3B polynomials (MBPolConfig.for_dynamics(); --rows caps the
batch), for the exact-product and the exp/log basis, it evaluates
(e, dE/dx) in float64 and in float32 with the product m2 @ W computed

  f32      plainly in float32 (ops/polyeval.pip_quad_energy_and_grad);
  bf16x6   from exact 3-way bf16 splits of m2 and W, the six highest cross
           products (ops/pip_fused.split_product: the twin of the kernels);
  bf16x3   the three highest of those (hi hi + hi mid + mid hi);
  tf32x3   from 2-way TF32 splits (11 + 11 significand bits, round to
           nearest), hi hi + hi lo + lo hi;

every elementary product exact and every sum in float32, and prints each
scheme's error against float64 as a share of max |e| and max |g|, and its
ratio to the plain float32 evaluation's error. A scheme qualifies for the
kernels when both ratios stay within pip_fused_check.ACC_FACTOR. The
emulation sums in the library's order; the order and rounding of a tensor
core's accumulator show only on the card (chip_smoke.py phase 9, `acc`).

For the monomial expansion (--what monomial; the first --monomial-rows rows
of each batch) mc = c * exp(sum of a monomial's four factor logs) is float32
and is split exactly three ways into bf16; the exponent matrix augmented
with a column of ones (`pip_fused.monomial_kernel_tables`: exact in bf16)
turns the energy and the gradient into one product. A tile is 16 monomials;
its three products are summed from zero, smallest part first, and the
candidates differ in how the 796 / 2,096 tile sums are added up:

  f32        no split: torch.sum(mc) and mc @ E in float32 (the plain
             float32 evaluation every ratio is taken against);
  twin       ops/pip_fused.pip_energy_grad_plain as it stands (it repeats
             the kernel's choice, tile2/f32x16);
  flat       the three products over all monomials at once, smallest part
             first (three library GEMMs);
  tile/f32   every tile's sum added to one float32 running sum, in order;
  tile/f64   the same into a double running sum;
  tileN/f32  N = 2, 4, 16 tiles summed in the tensor core's accumulator,
             then added to the float32 running sum;
  tile/f32xN  N = 8, 32: two levels of float32: tile sums into an inner sum,
             the inner sum into the outer one every N tiles;
  tile2/f32x16  both: sums of 2 tiles into an inner sum, flushed every 16
             (the kernel's choice).

Prints one JSON object as the last line.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIXTURE = os.path.join(REPO, 'tests', 'fixtures', 'water256_integration_test.npz')
BOX = 19.3996888399961804 / 10.0
ROW_CHUNK = 8192


def water256_variables(device, dtype=torch.float32):
    """{polynomial: x [P, V]} of the water256 fixture under for_dynamics()."""
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.models.three_body import three_body_variables
    from mbpol_openmm_plugin_tpu_torch.models.two_body import two_body_variables
    from mbpol_openmm_plugin_tpu_torch.system import (System, compute_virtual_sites,
                                                      make_molecules_whole)
    with np.load(FIXTURE) as z:
        system = System.from_atom_names(z['names'], z['resnames'], box=[BOX] * 3)
        pos = torch.as_tensor(np.array(z['positions']), dtype=dtype, device=device)
    pos = compute_virtual_sites(system, make_molecules_whole(system, pos))
    pot = MBPol(system, MBPolConfig.for_dynamics(), device=str(device))
    (pl, tl), _ = pot.build_neighbor_lists(pos)
    with torch.no_grad():
        return {'poly2b': two_body_variables(system, pos, pl[0], pl[1]).contiguous(),
                'poly3b': three_body_variables(system, pos, tl[0], tl[1]).contiguous()}


def split2_tf32(x):
    """(hi, lo) float32 tensors with 11 significand bits each (TF32), hi
    rounded to nearest; x - (hi + lo) is below 2^-22 |x|."""
    def tf32(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(scheme, m2, W):
    from mbpol_openmm_plugin_tpu_torch.ops import pip_fused, polyeval
    if scheme == 'f32':
        return m2 @ W
    if scheme == 'tf32x3':
        (mh, ml), (wh, wl) = split2_tf32(m2), split2_tf32(W)
        return (mh @ wl + ml @ wh) + mh @ wh
    ws = [w.to(device=m2.device, dtype=m2.dtype) for w in pip_fused.split_w(W.cpu().numpy())]
    if scheme == 'bf16x6':
        return pip_fused.split_product(m2, ws)
    m = [p.to(m2.dtype) for p in polyeval._split3_bf16(m2)]
    return (m[0] @ ws[1] + m[1] @ ws[0]) + m[0] @ ws[0]


SCHEMES = ('f32', 'bf16x6', 'bf16x3', 'tf32x3')


def evaluate(name, x, basis, scheme):
    """(e, g) with the W product by `scheme`, float32, in row chunks."""
    from mbpol_openmm_plugin_tpu_torch.ops import polyeval
    F, W, _, _ = polyeval._tables(name, x.dtype, x.device)
    e, g = [], []
    for xc in torch.split(x, ROW_CHUNK):
        m2 = polyeval.quad_basis(xc, name, basis)
        wm = product(scheme, m2, W)
        e.append(torch.sum(m2 * wm, dim=-1))
        g.append(((m2 * (2.0 * wm)) @ F) / xc)
    return torch.cat(e), torch.cat(g)


MONO_SCHEMES = ('f32', 'twin', 'flat', 'tile/f32', 'tile/f64', 'tile2/f32', 'tile4/f32', 'tile16/f32',
                'tile/f32x8', 'tile/f32x32', 'tile2/f32x16')
MONO_ROW_CHUNK = 256


def _running_sum(parts, dtype, inner=None):
    """Sum of parts [P, T, N] over T in order, one add at a time, in
    `dtype`; with `inner`, through an inner sum flushed every `inner`
    terms."""
    total = torch.zeros_like(parts[:, 0], dtype=dtype)
    run = torch.zeros_like(total)
    for t in range(parts.shape[1]):
        run = run + parts[:, t].to(dtype)
        if inner and (t + 1) % inner == 0:
            total, run = total + run, torch.zeros_like(run)
    return total + run if inner else run


def monomial_candidates(name, x):
    """{scheme: (e, g)} of MONO_SCHEMES on float32 x [P, V], in row chunks."""
    from mbpol_openmm_plugin_tpu_torch.ops import pip_fused, polyeval
    tables = pip_fused.monomial_kernel_tables(name)
    v = x.shape[1]
    idx = torch.as_tensor(tables.factors.astype(np.int64), device=x.device)
    c = torch.as_tensor(tables.c, device=x.device)
    et = tables.et_aug.to(device=x.device, dtype=torch.float32)
    E = et[:, :v]
    tiles = et.reshape(-1, pip_fused.K_TILE, et.shape[1])               # [T, 16, 40]
    out = {s: ([], []) for s in MONO_SCHEMES}

    def keep(scheme, r, xc):
        out[scheme][0].append(r[:, v].float())
        out[scheme][1].append(r[:, :v].float() / xc)

    for xc in torch.split(x, MONO_ROW_CHUNK):
        la = torch.cat([torch.log(xc), torch.zeros_like(xc[:, :1])], dim=1)
        mc = torch.exp(((la[:, idx[:, 0]] + la[:, idx[:, 1]]) + la[:, idx[:, 2]])
                       + la[:, idx[:, 3]]) * c
        out['f32'][0].append(torch.sum(mc, dim=1))
        out['f32'][1].append((mc @ E) / xc)
        for o, r in zip(out['twin'], pip_fused.pip_energy_grad_plain(name, xc)):
            o.append(r)
        hi, mid, lo = (p.float() for p in polyeval._split3_bf16(mc))
        keep('flat', (lo @ et + mid @ et) + hi @ et, xc)
        for n in (1, 2, 4, 16):
            t = tiles.shape[0]
            tp = -(-t // n) * n
            def grouped(part):
                a = torch.nn.functional.pad(part, (0, (tp - t) * pip_fused.K_TILE))
                return a.reshape(len(xc), tp // n, n * pip_fused.K_TILE).transpose(0, 1)
            b = torch.nn.functional.pad(tiles, (0, 0, 0, 0, 0, tp - t)).reshape(
                tp // n, n * pip_fused.K_TILE, -1)
            parts = ((torch.bmm(grouped(lo), b) + torch.bmm(grouped(mid), b))
                     + torch.bmm(grouped(hi), b)).transpose(0, 1)       # [P, T / n, 40]
            if n == 1:
                keep('tile/f32', _running_sum(parts, torch.float32), xc)
                keep('tile/f64', _running_sum(parts, torch.float64), xc)
                for inner in (8, 32):
                    keep(f'tile/f32x{inner}', _running_sum(parts, torch.float32, inner), xc)
            else:
                keep(f'tile{n}/f32', _running_sum(parts, torch.float32), xc)
                if n == 2:
                    keep('tile2/f32x16', _running_sum(parts, torch.float32, 16), xc)
    return {s: (torch.cat(e), torch.cat(g)) for s, (e, g) in out.items()}


def monomial_readings(name, x):
    """Readings of MONO_SCHEMES on x: errors against the float64 monomial
    expansion over max |e|, max |g|, and their ratio to scheme 'f32'."""
    from mbpol_openmm_plugin_tpu_torch.ops import polyeval
    ref = [torch.cat(parts) for parts in zip(*(
        polyeval.pip_energy_and_grad(xc.double(), name)
        for xc in torch.split(x, MONO_ROW_CHUNK)))]
    scale = [float(r.abs().max()) for r in ref]
    got = monomial_candidates(name, x)
    err = {s: [float((a.double() - r).abs().max()) / sc for a, r, sc in zip(got[s], ref, scale)]
           for s in MONO_SCHEMES}
    rows = []
    for s in MONO_SCHEMES:
        ratio = [a / b for a, b in zip(err[s], err['f32'])]
        print(f'{name} [{x.shape[0]}, {x.shape[1]}] monomial {s:11s} '
              f'e {err[s][0]:.3e} ({ratio[0]:.2f} x f32)  g {err[s][1]:.3e} '
              f'({ratio[1]:.2f} x f32)  of max |e| {scale[0]:.4f}, max |g| {scale[1]:.4f}',
              flush=True)
        rows.append(dict(poly=name, rows=x.shape[0], basis='monomial', scheme=s,
                         err_e=err[s][0], err_g=err[s][1], ratio_e=ratio[0], ratio_g=ratio[1]))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--device', default='cpu', choices=('cpu', 'cuda'))
    ap.add_argument('--rows', type=int, default=None, help='cap on the rows per polynomial')
    ap.add_argument('--what', default='all', choices=('quad', 'monomial', 'all'))
    ap.add_argument('--monomial-rows', type=int, default=2048,
                    help='rows per polynomial of the monomial readings')
    args = ap.parse_args(argv)
    import mbpol_openmm_plugin_tpu_torch  # noqa: F401  (precision switches)
    from mbpol_openmm_plugin_tpu_torch.ops import pip_fused_check, polyeval
    dev = torch.device(args.device)
    out = dict(device=args.device if args.device == 'cpu' else torch.cuda.get_device_name(0),
               acc_factor=pip_fused_check.ACC_FACTOR, readings=[])
    for name, x in water256_variables(dev).items():
        x = x[:args.rows]
        if args.what != 'quad':
            out['readings'] += monomial_readings(name, x[:args.monomial_rows])
        for basis in ('gather', 'explog') if args.what != 'monomial' else ():
            ref = [torch.cat(parts) for parts in zip(*(
                polyeval.pip_quad_energy_and_grad(xc.double(), name, basis=basis)
                for xc in torch.split(x, ROW_CHUNK)))]
            scale = [float(r.abs().max()) for r in ref]
            err = {}
            for scheme in SCHEMES:
                got = evaluate(name, x, basis, scheme)
                err[scheme] = [float((a.double() - r).abs().max()) / s
                               for a, r, s in zip(got, ref, scale)]
            for scheme in SCHEMES:
                ratio = [a / b for a, b in zip(err[scheme], err['f32'])]
                print(f'{name} [{x.shape[0]}, {x.shape[1]}] {basis:7s} {scheme:7s} '
                      f'e {err[scheme][0]:.3e} ({ratio[0]:.2f} x f32)  '
                      f'g {err[scheme][1]:.3e} ({ratio[1]:.2f} x f32)  of max |e| '
                      f'{scale[0]:.4f}, max |g| {scale[1]:.4f}', flush=True)
                out['readings'].append(dict(poly=name, rows=x.shape[0], basis=basis,
                                            scheme=scheme, err_e=err[scheme][0],
                                            err_g=err[scheme][1], ratio_e=ratio[0],
                                            ratio_g=ratio[1]))
    print(json.dumps(out))


if __name__ == '__main__':
    main()
