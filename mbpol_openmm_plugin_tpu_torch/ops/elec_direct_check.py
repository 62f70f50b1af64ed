"""Acceptance checks of the direct-space CUDA kernels of ops/elec_direct.py
and ops/elec_direct_bs.py against their plain twins, shared by
chip_smoke.py and tests/test_torch_kernels_cuda.py.

Each output is compared on sets of entries, each against the largest
|twin| entry of its own set, so that no set's bound is scaled by another
set's large entries:

K1 s3/s5, entries between two polarizable sites (O, H; i != j). These
are the entries the SCF dipole field uses. Held at REL (1e-5 of the
set's max), and each entry also at |k - t64| <= ELEM * |t64| + 1e-7 * max
against the float64 twin, so a few-percent error in one cross-molecule
entry cannot hide under the set's largest (same-molecule O-H) entries.
The block set is larger (2.4e8 pairs at water4096) and holds a few
entries where the terms of s5 cancel, where the float32 twin itself reads
~4e-5 per entry on water4096 (PERF.md); its per-entry bound is ELEM_BS.
The dense water4096 rows of the full-grid kernel #3 hold the same sites,
and k1_rows_range takes ELEM_BS there (twin_elem_range reads the float32
twin's own distance).

K1 s3/s5, entries with an M site. The SCF multiplies them by zero (M
sites have zero polarizability, so mu_M = 0 and the field at M is never
used). Their largest entries are same-molecule O-M pairs (r ~ 0.022 nm)
where bn2 and (1 - s_dd5) rr5 cancel from ~1e9 to ~1e5, so any float32
evaluation is ~1e-4 (s3) and ~5e-4 (s5) of the set's max from float64.
Held at REL_M = 2e-3, and the kernel's error against the float64 twin at
most twice the float32 twin's own (ACC).

K1 field, rows of H and M sites: REL. Rows of O sites: every O row holds
its own water's O-M pair, where the removal of the reciprocal-space term
bn1 - rr3 cancels ~2.7e3 to ~1, so float32 is ~1e-5 to 2e-5 of the max
from float64. Held at REL_O = 5e-5 and ACC.

K2 e_direct at REL, force and pot at 1e-4 of their max.

The block-sparse kernels are held to the same sets: K1-bs's s3/s5, its
live lines and the twin's each spread into the [cap, 256, 256] blocks of
the Pallas layout (`lines_to_blocks`, zeros outside the lines), on the
pairs of valid list entries between real, distinct sites (split into
polarizable pairs and pairs with an M site as above), and its field rows;
K2-bs as K2. K3-bs (one SCF dipole field from given s3/s5 lines) is
compared on the same lines as the twin, so only the summation order
differs: field rows of polarizable sites and of M sites each at REL.
"""
from __future__ import annotations

import dataclasses

import torch

from mbpol_openmm_plugin_tpu_torch.ops.elec_direct import _ISO

REL = 1e-5
ELEM = 2e-5
ELEM_BS = 8e-5
ELEM_FLOOR = 1e-7
REL_M = 2e-3
REL_O = 5e-5
REL_K2 = {'e_direct': 1e-5, 'force': 1e-4, 'pot': 1e-4}
ACC_FACTOR, ACC_FLOOR = 2.0, 1e-6


@dataclasses.dataclass
class Row:
    output: str
    entries: str
    measure: str
    value: float
    bound: float

    @property
    def ok(self):
        return self.value <= self.bound

    def __str__(self):
        return (f'{self.output:8s} {self.entries:22s} {self.measure:5s} {self.value:.3e} '
                f'(bound {self.bound:.1e})  {"PASS" if self.ok else "FAIL"}')


def _rel(k, t):
    return float((k - t).abs().max() / t.abs().max().clamp_min(1e-30))


def _elem(k, t64):
    """max over entries of (|k - t64| - ELEM_FLOOR * max|t64|) / |t64|."""
    t64 = t64.double()
    excess = ((k.double() - t64).abs() - ELEM_FLOOR * t64.abs().max()).clamp_min(0.0)
    return float((excess / t64.abs().clamp_min(1e-300)).max())


def _acc(k, t, t64):
    """Kernel error against float64 over the allowed one: ACC_FACTOR times
    the float32 twin's own error, plus ACC_FLOOR of the max."""
    t64 = t64.double()
    allowed = (ACC_FACTOR * (t.double() - t64).abs().max()
               + ACC_FLOOR * t64.abs().max())
    return float((k.double() - t64).abs().max() / allowed.clamp_min(1e-300))


def _rows(output, entries, k, t, t64, rel_bound, elem=None, acc=False):
    """Rows of one entry set: rel always; elem (per entry against float64,
    bound `elem`) and acc where asked."""
    rows = [Row(output, entries, 'rel', _rel(k, t), rel_bound)]
    if elem is not None:
        rows.append(Row(output, entries, 'elem', _elem(k, t64), elem))
    if acc:
        rows.append(Row(output, entries, 'acc', _acc(k, t, t64), 1.0))
    if not bool(torch.isfinite(k).all()):
        rows.append(Row(output, entries, 'finite', float('inf'), 0.0))
    return rows


def k1_rows(sites, polarity, kern, twin, twin64):
    """Rows of the K1 check. sites [N,8] packed sites, polarity [N];
    kern/twin/twin64 = (field, s3, s5) of the kernel, the float32 twin
    and the float64 twin on the same inputs."""
    n = sites.shape[0]
    pol = polarity.to(sites.device) > 0
    notself = ~torch.eye(n, dtype=torch.bool, device=sites.device)
    both = pol[:, None] & pol[None, :]
    return _k1_rows(both & notself, ~both & notself, sites[:, _ISO] > 0.5, kern, twin, twin64,
                    ELEM)


def k1_rows_range(sites, polarity, lo, hi, kern, twin, twin64, elem=ELEM):
    """Rows of the check of the full-grid row kernel #3 on the rows [lo,
    hi) of N real sites: kern/twin/twin64 = (field [rows, 3], s3, s5
    [rows, n_cols]) of the kernel and the float32 and float64 twins; the
    entries of real rows and columns, in the sets of k1_rows. elem: the
    per-entry bound of the polarizable pairs, ELEM; ELEM_BS for the dense
    water4096 (the block set's sites, where the float32 twin itself reads
    3.3e-5 on s5 on the H100)."""
    n = sites.shape[0]
    hi = min(hi, n)
    r = hi - lo
    pol = polarity.to(sites.device) > 0
    rows = torch.arange(lo, hi, device=sites.device)
    notself = rows[:, None] != torch.arange(n, device=sites.device)[None, :]
    both = pol[lo:hi, None] & pol[None, :]
    real = [(x[0][:r],) + tuple(m[:r, :n] for m in x[1:]) for x in (kern, twin, twin64)]
    return _k1_rows(both & notself, ~both & notself, sites[lo:hi, _ISO] > 0.5, *real, elem)


def twin_elem_range(sites, polarity, lo, hi, twin, twin64):
    """The float32 twin's own per-entry distance from the float64 twin (the
    elem measure) on the polarizable pairs of the rows [lo, hi): (s3, s5)."""
    n = sites.shape[0]
    hi = min(hi, n)
    pol = polarity.to(sites.device) > 0
    rows = torch.arange(lo, hi, device=sites.device)
    pp = (pol[lo:hi, None] & pol[None, :]) & (rows[:, None]
                                               != torch.arange(n, device=sites.device)[None, :])
    r = hi - lo
    return tuple(_elem(t[:r, :n][pp], t64[:r, :n][pp]) for t, t64 in zip(twin[1:], twin64[1:]))


def _block_sets(polarity, tiles, n_sites, n_pad):
    """Masks [cap, 256, 256] of the K1-bs entry sets (polarizable pairs,
    pairs with an M site) over valid list entries, real and distinct
    sites; polarity [n] in the sorted site order."""
    from mbpol_openmm_plugin_tpu_torch.ops.elec_direct_bs import TILE, VALID
    dev = tiles.ti.device
    pol = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    pol[:n_sites] = polarity.to(dev) > 0
    lane = torch.arange(TILE, device=dev)
    gi = (tiles.ti.long()[:, None] + tiles.row_tile0) * TILE + lane
    gj = tiles.tj.long()[:, None] * TILE + lane
    real = (((tiles.meta & VALID) > 0)[:, None, None] & (gi < n_sites)[:, :, None]
            & (gj < n_sites)[:, None, :] & (gi[:, :, None] != gj[:, None, :]))
    both = pol[gi][:, :, None] & pol[gj][:, None, :]
    return real & both, real & ~both


def _list_rows(tiles, n_sites):
    """The sorted rows a tile list's outputs hold (its real rows)."""
    from mbpol_openmm_plugin_tpu_torch.ops.elec_direct_bs import TILE
    r0 = tiles.row_tile0 * TILE
    return slice(r0, r0 + tiles.rows_kept(n_sites))


def k1_bs_rows(sites, polarity, tiles, n_sites, kern, twin, twin64):
    """Rows of the K1-bs check. sites [np_, 8] sorted packed sites,
    polarity [n] in the same order, tiles the active tile-pair list (of all
    row tiles, or of a shard's); kern/twin/twin64 = (field of the list's
    rows [rows, 3], s3, s5 [cap,256,256]) of the kernel and the float32 and
    float64 twins, their lines spread into blocks."""
    pp, with_m = _block_sets(polarity, tiles, n_sites, sites.shape[0])
    is_o = sites[_list_rows(tiles, n_sites), _ISO] > 0.5
    return _k1_rows(pp, with_m, is_o, kern, twin, twin64, ELEM_BS)


def k3_bs_rows(polarity, kern, twin):
    """Rows of the K3-bs check: the dipole field [n,3] of kernel and twin
    from the same s3/s5 blocks; polarity [n] in the same site order."""
    pol = polarity.to(kern.device) > 0
    return (_rows('field', 'polarizable rows', kern[pol], twin[pol], None, REL)
            + _rows('field', 'M rows', kern[~pol], twin[~pol], None, REL))


def _k1_rows(pp, with_m, is_o, kern, twin, twin64, elem):
    rows = []
    for name, k, t, t64 in zip(('s3', 's5'), kern[1:], twin[1:], twin64[1:]):
        rows += _rows(name, 'polarizable pairs', k[pp], t[pp], t64[pp], REL, elem=elem)
        rows += _rows(name, 'pairs with an M site', k[with_m], t[with_m], t64[with_m],
                      REL_M, acc=True)
    k, t, t64 = kern[0], twin[0], twin64[0]
    rows += _rows('field', 'H and M rows', k[~is_o], t[~is_o], t64[~is_o], REL)
    rows += _rows('field', 'O rows', k[is_o], t[is_o], t64[is_o], REL_O, acc=True)
    return rows


def k2_rows(kern, twin):
    """Rows of the K2 check: (e_direct, force, pot) of kernel and twin."""
    rows = []
    for name, k, t in zip(('e_direct', 'force', 'pot'), kern, twin):
        rows += _rows(name, 'all', k, t, None, REL_K2[name])
    return rows


def block_kernel_rows(sites, polarity, tiles, n_sites, c, n_lines=None, mu=None):
    """Run K1-bs, K3-bs and K2-bs and their plain twins on the same inputs
    (K3-bs and K2-bs on dipoles of realistic size: by default polarity
    times the direct fixed field, which needs a list of every row tile;
    for a shard's list, pass the dipoles mu [n, 3]; K1-bs and its twins
    with line capacity n_lines) and check them on the list's rows. sites
    [np_, 8] sorted packed sites, polarity [n] in the same order. Returns
    {wrapper name: (rows, max |kernel - twin| over the outputs)}."""
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as bs

    def k1_blocks(k1):
        return (k1[0],) + bs.lines_to_blocks(k1[1], tiles)

    k1_lines = bs.fixed_field_and_scf_lines(sites, n_sites, tiles, c, n_lines)
    k1 = k1_blocks(k1_lines)
    t1 = k1_blocks(bs.fixed_field_and_scf_lines_plain(sites, n_sites, tiles, c, n_lines))
    t1_64 = k1_blocks(bs.fixed_field_and_scf_lines_plain(sites.double(), n_sites, tiles, c,
                                                         n_lines))
    if mu is None:
        mu = (polarity.to(sites)[:, None] * t1[0]).contiguous()
    mu_pad = bs.pad_rows(mu, sites.shape[0])
    k3 = bs.scf_dipole_field_bs(sites, k1_lines[1], mu_pad, tiles, n_sites, c)
    t3 = bs.scf_dipole_field_bs_plain(sites, k1_lines[1], mu_pad, tiles, n_sites, c)
    k2 = bs.direct_energy_force_pot_bs(sites, mu, n_sites, tiles, c)
    t2 = bs.direct_energy_force_pot_bs_plain(sites, mu, n_sites, tiles, c)

    def max_abs(kern, twin):
        return max(float((k - t).abs().max()) for k, t in zip(kern, twin))

    return {
        'fixed_field_and_scf_lines': (k1_bs_rows(sites, polarity, tiles, n_sites, k1, t1, t1_64),
                                      max_abs(k1, t1)),
        'scf_dipole_field_bs': (k3_bs_rows(polarity[_list_rows(tiles, n_sites)], k3, t3),
                                max_abs((k3,), (t3,))),
        'direct_energy_force_pot_bs': (k2_rows(k2, t2), max_abs(k2, t2)),
    }
