"""Block-sparse direct-space PME electrostatics for large boxes: the active
tile-pair machinery, three hand-written CUDA kernels and their plain
PyTorch twins (counterpart of mbpol_openmm_plugin_tpu/ops/elec_pallas_bs.py).

The dense kernels (ops/elec_direct.py) visit all N^2 site pairs and keep
[N, N] SCF factor matrices. Here the sites are sorted spatially
(`molecule_sort_permutation`), padded to a multiple of TILE = 256, and
only tile pairs whose bounding boxes come within the cutoff are visited:
a padded row-major list (ti, tj, meta) of active tile pairs holds both
(I, J) and (J, I), so each row tile's partners are one consecutive run of
the list, starting at `row_start[I]`.

The kernels cull at warp granularity: a (row water, 32-site column
cluster) LINE of an active block is skipped when the minimum-image gap
between the two groups' boxes exceeds the cutoff (`group_boxes`,
`live_lines` are the plain twin of that test; the kernels compute the
boxes on the card).

K1-bs `fixed_field_and_scf_lines` replaces the Pallas kernel
`_fixed_field_bs_kernel`: fixed-field rows and the s3/s5 factors of the
live lines only (`ScfLines`: per (row water, cluster) a slab of
`capacity` lines in list-entry order). The Pallas kernel's [cap, 256, 256]
blocks hold the same values, with zeros outside the live lines;
`lines_to_blocks` / `blocks_to_lines` convert between the two for the
tests and the checks.
K3-bs `scf_dipole_field_bs` replaces `_scf_field_bs_kernel`: one SCF
dipole-field evaluation over the stored lines.
K2-bs `direct_energy_force_pot_bs` replaces `_pair_force_bs_kernel`:
direct-space energy, forces and per-site potential.

Dispatch, as in ops/elec_direct.py: CPU tensors go to the plain twins
(`*_plain`), CUDA float32 tensors to the kernels, anything else raises;
there is no fallback. The twins gather [chunk, 256, 8] row and column
tiles per list entry and run the formulas of ops/elec_direct.k1_terms /
k2_terms on [chunk, 256, 256], so they also run at water4096 on the card
(chip_smoke.py and the cuda tests compare the kernels with them). The
`*_blocks_plain` twins keep the Pallas kernels' block layout, as the
reference the line twins are held to. Each kernel wrapper counts its
launches in its `launches` attribute. What bounds the kernels on the H100
and their design: csrc/elec_direct_bs.cu.

Not ported yet: the row-sharded `*_sharded` wrappers and their row-slice
tile lists (multi-GPU, see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch.models.electrostatics import dipole_field
from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
from mbpol_openmm_plugin_tpu_torch.ops.neighbors import _first_true
from mbpol_openmm_plugin_tpu_torch.utils.consts import device_const

TILE = 256
# metadata bit flags per tile pair (elec_pallas_bs._VALID, _FIRST_IN_ROW;
# the kernels read only VALID: row_start takes FIRST_IN_ROW's place)
VALID = 1
FIRST_IN_ROW = 2
# list entries per step of the twins: [CHUNK, 256, 256] pair tensors
CHUNK = 16
# the kernels' culling test (csrc/elec_direct_bs.cu): row groups of one
# water, column clusters of one warp, and the padding of each half extent
# (nm, and per nm of the group's first coordinate)
WATER = 4
CLUSTER = 32
CULL_MARGIN = 1e-4
CULL_REL = 2e-6
EMPTY = -1e30


def padded(n):
    """Site count padded to a multiple of TILE (elec_pallas._padded)."""
    return ((n + TILE - 1) // TILE) * TILE


# ----------------------------------------------------------------------
# Active tile-pair machinery
# ----------------------------------------------------------------------

def tile_pair_capacity(n_sites, box, cutoff, tile=TILE, factor=1.3):
    """Static capacity for the symmetric active tile-pair list."""
    n_tiles = padded(n_sites) // tile
    box = np.asarray(box, np.float64)
    vol = float(np.prod(box))
    # sites per tile occupy ~tile/density volume; treat the tile extent as a
    # cube of that volume and count neighbor tiles within cutoff + 2 extents
    density = n_sites / vol
    side = (tile / density) ** (1.0 / 3.0)
    reach = cutoff + 2.0 * side
    per = min(n_tiles, int(np.ceil(factor * (4.0 / 3.0) * np.pi * reach ** 3
                                   * density / tile)) + 3)
    return min(n_tiles * per, n_tiles * n_tiles)


def _tile_aabbs(positions, n_sites, box, tile):
    """Per-tile wrapped-coordinate AABBs: (center [T,3], half [T,3],
    has_sites [T])."""
    np_ = positions.shape[0]
    n_tiles = np_ // tile
    dt, dev = positions.dtype, positions.device
    b = device_const(np.asarray(box, np.float64), dtype=dt, device=dev)
    valid_site = (torch.arange(np_, device=dev) < n_sites)[:, None]
    p3 = positions.reshape(n_tiles, tile, 3)
    v3 = valid_site.reshape(n_tiles, tile, 1)
    # wrap sites into the primary box before taking bounds (AABB in wrapped
    # coordinates; the per-axis gap below is computed minimum-image)
    p3 = p3 - torch.floor(p3 / b) * b
    mins = torch.amin(torch.where(v3, p3, 1e30), dim=1)            # [T,3]
    maxs = torch.amax(torch.where(v3, p3, -1e30), dim=1)
    center = 0.5 * (mins + maxs)
    half = 0.5 * (maxs - mins)
    has_sites = torch.any(v3[:, :, 0], dim=1)
    return center, half, has_sites


@dataclasses.dataclass
class TileList:
    """A padded row-major active tile-pair list (all int32 tensors on the
    sites' device, no host sync to build): ti/tj/meta [cap], the count of
    active pairs n_act (0-d tensor; n_act > cap is an overflow) and
    row_start [n_tiles + 1], the start of each row tile's run."""
    ti: torch.Tensor
    tj: torch.Tensor
    meta: torch.Tensor
    n_act: torch.Tensor
    row_start: torch.Tensor

    @property
    def capacity(self):
        return self.ti.shape[0]


def active_tile_pairs(positions, n_sites, box, cutoff, capacity, tile=TILE):
    """Padded row-major list of active tile pairs from per-tile AABBs
    (elec_pallas_bs.active_tile_pairs; its row-slice form
    active_tile_pairs_rows serves the sharded wrappers, not ported).
    positions: [np_, 3] (sites sorted spatially; rows >= n_sites are
    padding). Conservative superset: a pair is active when the per-axis
    minimum-image AABB gap is <= cutoff on every axis. Returns a TileList."""
    n_tiles = positions.shape[0] // tile
    dt, dev = positions.dtype, positions.device
    b = device_const(np.asarray(box, np.float64), dtype=dt, device=dev)
    center, half, has_sites = _tile_aabbs(positions, n_sites, box, tile)
    dc = center[None, :, :] - center[:, None, :]                   # [T, T, 3]
    dc = dc - torch.floor(dc / b + 0.5) * b
    gap = torch.abs(dc) - (half[:, None, :] + half[None, :, :])
    act = torch.all(gap <= cutoff, dim=-1) & has_sites[:, None] & has_sites[None, :]

    sel, valid, n_act = _first_true(act.reshape(-1), capacity)     # row-major
    ti = (sel // n_tiles).to(torch.int32)
    tj = (sel % n_tiles).to(torch.int32)
    # padded entries: park on the last row tile; their contribution is
    # masked to 0 (the kernels and twins skip entries without VALID)
    ti = torch.where(valid, ti, n_tiles - 1)
    tj = torch.where(valid, tj, n_tiles - 1)
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), ti[1:] != ti[:-1]])
    meta = (valid.to(torch.int32) * VALID + first.to(torch.int32) * FIRST_IN_ROW)
    # ti is non-decreasing (row-major, padding parked last), so each row
    # tile's run starts where searchsorted puts it
    row_start = torch.searchsorted(
        ti, torch.arange(n_tiles + 1, dtype=torch.int32, device=dev)).to(torch.int32)
    return TileList(ti=ti, tj=tj, meta=meta.to(torch.int32), n_act=n_act, row_start=row_start)


def molecule_sort_permutation(o_positions, box, mols_per_tile=TILE // 4):
    """Static serpentine cell-major molecule permutation (numpy, computed
    once at setup). Cells hold ~one tile's worth of molecules and are
    walked boustrophedon, so a tile that straddles a cell boundary spans two
    ADJACENT cells: compact tile AABBs are what make tile pairs inactive.
    Correctness never depends on the sort; tile AABBs are recomputed per
    call."""
    o = np.asarray(o_positions, np.float64)
    b = np.asarray(box, np.float64)
    o = o - np.floor(o / b) * b
    n = len(o)
    density = n / float(np.prod(b))
    cell = (mols_per_tile / density) ** (1.0 / 3.0)
    ncell = np.maximum(np.round(b / cell).astype(int), 1)
    ci = np.minimum((o / (b / ncell)).astype(int), ncell - 1)
    cx, cy, cz = ci[:, 0], ci[:, 1], ci[:, 2]
    # serpentine: flip y within odd x-planes, flip z within odd y-rows
    cy_s = np.where(cx % 2 == 1, ncell[1] - 1 - cy, cy)
    cz_s = np.where(cy_s % 2 == 1, ncell[2] - 1 - cz, cz)
    key = (cx * ncell[1] + cy_s) * ncell[2] + cz_s
    return np.argsort(key, kind='stable')


def pack_sites(positions, charges, d16_inv, mol_index, is_o):
    """[padded(N), 8] packed sites (ops/elec_direct.pack_sites layout);
    padded rows are zero with molecule id -1."""
    s = ED.pack_sites(positions, charges, d16_inv, mol_index, is_o)
    n = s.shape[0]
    pad = s.new_zeros((padded(n) - n, ED.NS))
    pad[:, ED._MOL] = -1.0
    return torch.cat([s, pad], dim=0)


def pad_rows(x, n_rows):
    """x [n, 3] with zero rows appended up to n_rows (contiguous)."""
    return torch.cat([x, x.new_zeros((n_rows - x.shape[0],) + tuple(x.shape[1:]))]).contiguous()


def group_boxes(xyz, n_sites, box, size):
    """Boxes of the groups of `size` consecutive sites of xyz [np_, 3]
    (sites >= n_sites are padding): (center [G, 3], half [G, 3]), each box
    holding an image of every real site of its group. The extents are those
    of the sites' minimum images relative to the group's first site, so a
    group across the periodic boundary or in unwrapped coordinates keeps a
    tight box; each half extent is padded by CULL_MARGIN + CULL_REL |first
    coordinate|. A group without real sites has half = EMPTY."""
    g = xyz.shape[0] // size
    b = device_const(np.asarray(box, np.float64), dtype=xyz.dtype, device=xyz.device)
    p = xyz.reshape(g, size, 3)
    ref = p[:, 0, :]
    d = p - ref[:, None, :]
    d = d - torch.floor(d / b + 0.5) * b
    real = (torch.arange(g * size, device=xyz.device) < n_sites).reshape(g, size, 1)
    lo = torch.amin(torch.where(real, d, float('inf')), dim=1)
    hi = torch.amax(torch.where(real, d, float('-inf')), dim=1)
    some = real.any(dim=1)
    center = torch.where(some, ref + 0.5 * (lo + hi), 0.0)
    half = torch.where(some, 0.5 * (hi - lo) + CULL_MARGIN + CULL_REL * ref.abs(), EMPTY)
    return center, half


def live_lines(xyz, n_sites, tiles: TileList, box, cutoff):
    """The culling test of K3-bs/K2-bs: [cap, 64, 8] bool, True where row
    water w of entry p's row tile and column cluster g of its column tile
    may hold a pair within the cutoff (False for padded entries). A line is
    dead when the per-axis minimum-image gaps between the two boxes, each
    |dc| - (half_a + half_b) floored at 0, give a distance above the
    cutoff: on each axis that gap is a lower bound of every pair's
    minimum-image separation."""
    b = device_const(np.asarray(box, np.float64), dtype=xyz.dtype, device=xyz.device)
    rc, rh = (x.reshape(-1, TILE // WATER, 3) for x in group_boxes(xyz, n_sites, box, WATER))
    cc, ch = (x.reshape(-1, TILE // CLUSTER, 3) for x in group_boxes(xyz, n_sites, box, CLUSTER))
    ti, tj = tiles.ti.long(), tiles.tj.long()
    dc = cc[tj][:, None, :, :] - rc[ti][:, :, None, :]
    dc = dc - torch.floor(dc / b + 0.5) * b
    gap = torch.clamp(dc.abs() - (rh[ti][:, :, None, :] + ch[tj][:, None, :, :]), min=0.0)
    valid = ((tiles.meta & VALID) > 0)[:, None, None]
    return (torch.sum(gap * gap, dim=-1) <= cutoff * cutoff) & valid


# ----------------------------------------------------------------------
# s3/s5 as live lines
# ----------------------------------------------------------------------

@dataclasses.dataclass
class ScfLines:
    """K1-bs's s3/s5 as live lines. Slab (water, g) holds the lines of row
    water `water` (sorted rows 4 water .. 4 water + 3) and column cluster g
    (columns 32 g .. 32 g + 31 of a column tile), in list-entry order:
    s3, s5 [np_ / 4, 8, L, 4, 32] (line l: rows x columns), entry
    [np_ / 4, 8, L] int32 (the list entry of line l), count [np_ / 4, 8]
    int32 (the slab's live lines; count > L is an overflow, and only the
    first L are stored). Slots past min(count, L) hold no data."""
    s3: torch.Tensor
    s5: torch.Tensor
    entry: torch.Tensor
    count: torch.Tensor

    @property
    def capacity(self):
        """L, the lines a slab can hold."""
        return self.entry.shape[-1]

    def overflow(self):
        """0-d bool tensor on the lines' device: some slab lost lines."""
        return torch.amax(self.count) > self.capacity

    def nbytes(self):
        """Bytes allocated for s3 and s5."""
        return 2 * self.s3.numel() * self.s3.element_size()


def default_line_capacity(n_pad):
    """The line capacity that never overflows for n_pad padded sites: the
    number of column tiles (no row tile's run of the list is longer)."""
    return n_pad // TILE


def _new_lines(n_pad, n_lines, dtype, device, fill):
    """ScfLines of capacity n_lines for n_pad padded sites, allocated by
    `fill` (torch.empty for the kernel, torch.zeros for the twins)."""
    shape = (n_pad // WATER, TILE // CLUSTER, n_lines, WATER, CLUSTER)
    return ScfLines(s3=fill(shape, dtype=dtype, device=device),
                    s5=fill(shape, dtype=dtype, device=device),
                    entry=fill(shape[:3], dtype=torch.int32, device=device),
                    count=fill(shape[:2], dtype=torch.int32, device=device))


def line_slots(live, tiles: TileList):
    """(slot [cap, 64, 8], count [n_tiles * 64, 8]) of the live lines
    `live` [cap, 64, 8]: a line's slot is its place in its slab (row water,
    cluster), the number of live lines of that slab at earlier entries of
    the row tile's run; count is each slab's number of live lines."""
    cs = torch.cumsum(live.to(torch.int32), dim=0, dtype=torch.int32)
    cs = torch.cat([torch.zeros_like(cs[:1]), cs])                 # [cap + 1, 64, 8]
    start = cs[tiles.row_start.long()]                              # [n_tiles + 1, 64, 8]
    slot = cs[:-1] - start[tiles.ti.long()]
    return slot, (start[1:] - start[:-1]).reshape(-1, live.shape[2])


_BLOCK_AS_LINES = (-1, TILE // WATER, WATER, TILE // CLUSTER, CLUSTER)


def _put_lines(lines: ScfLines, b3, b5, live, slot, tiles: TileList, sl):
    """Store the live lines of the blocks b3/b5 [c, 256, 256] of the list
    entries `sl` into their slots (lines past the capacity are dropped)."""
    put = live[sl] & (slot[sl] < lines.capacity)
    e, wl, g = torch.nonzero(put, as_tuple=True)
    water = tiles.ti[sl].long()[e] * (TILE // WATER) + wl
    s = slot[sl][e, wl, g].long()
    lines.s3[water, g, s] = b3.reshape(_BLOCK_AS_LINES)[e, wl, :, g, :]
    lines.s5[water, g, s] = b5.reshape(_BLOCK_AS_LINES)[e, wl, :, g, :]
    lines.entry[water, g, s] = (e + sl.start).to(torch.int32)


def _line_index(lines: ScfLines):
    """(entry, water, cluster, slot) of the stored lines, sorted by entry."""
    stored = (torch.arange(lines.capacity, device=lines.count.device)
              < lines.count[..., None])
    water, g, s = torch.nonzero(stored, as_tuple=True)
    p = lines.entry[water, g, s].long()
    order = torch.argsort(p, stable=True)
    return p[order], water[order], g[order], s[order]


def _expand(lines: ScfLines, index, sl):
    """s3/s5 blocks [c, 256, 256] of the list entries `sl`: the stored
    lines of those entries (`index` from _line_index), zeros elsewhere."""
    p, water, g, s = index
    lo, hi = (int(x) for x in torch.searchsorted(
        p, torch.tensor([sl.start, sl.stop], device=p.device)))
    p, water, g, s = p[lo:hi] - sl.start, water[lo:hi], g[lo:hi], s[lo:hi]
    shape = (sl.stop - sl.start,) + _BLOCK_AS_LINES[1:]
    out = []
    for x in (lines.s3, lines.s5):
        b = x.new_zeros(shape)
        b[p, water % (TILE // WATER), :, g, :] = x[water, g, s]
        out.append(b.reshape(-1, TILE, TILE))
    return tuple(out)


def lines_to_blocks(lines: ScfLines, tiles: TileList):
    """(s3, s5) [cap, 256, 256], the Pallas kernel's layout: each stored
    line in its block, zeros elsewhere (tests and checks only)."""
    return _expand(lines, _line_index(lines), slice(0, tiles.capacity))


def blocks_to_lines(s3, s5, tiles: TileList, live, n_lines):
    """ScfLines of capacity n_lines holding the lines `live` [cap, 64, 8]
    of the blocks s3/s5 [cap, 256, 256] (tests and checks only)."""
    n_pad = (tiles.row_start.shape[0] - 1) * TILE
    lines = _new_lines(n_pad, n_lines, s3.dtype, s3.device, torch.zeros)
    slot, lines.count = line_slots(live, tiles)
    _put_lines(lines, s3, s5, live, slot, tiles, slice(0, tiles.capacity))
    return lines


# ----------------------------------------------------------------------
# Plain PyTorch twins, chunked over list entries
# ----------------------------------------------------------------------

def _chunks(tiles: TileList, chunk):
    for a in range(0, tiles.capacity, chunk):
        yield slice(a, min(a + chunk, tiles.capacity))


def _entry_tiles(sites, tiles: TileList, sl, n_sites):
    """Row and column tiles [c, 256, 8] of the list entries `sl`, and the
    mask [c, 256, 256] of pairs that count: valid entry, both sites real,
    not the same site."""
    st = sites.reshape(-1, TILE, ED.NS)
    ti, tj = tiles.ti[sl].long(), tiles.tj[sl].long()
    lane = torch.arange(TILE, device=sites.device)
    gi, gj = ti[:, None] * TILE + lane, tj[:, None] * TILE + lane          # [c, 256]
    valid = (tiles.meta[sl] & VALID) > 0
    mask = ((gi[:, :, None] != gj[:, None, :]) & (gi < n_sites)[:, :, None]
            & (gj < n_sites)[:, None, :] & valid[:, None, None])
    return st[ti], st[tj], mask, ti, tj


def _k1_plain(sites, n_sites, tiles: TileList, c: ED.DirectConsts, chunk, store):
    """The fixed field [n, 3] of K1-bs's formulas; store(sl, s3, s5) takes
    each chunk's blocks [c, 256, 256] (zero for padded entries)."""
    n_tiles = sites.shape[0] // TILE
    field = sites.new_zeros((n_tiles, TILE, 3))
    for sl in _chunks(tiles, chunk):
        srow, scol, mask, ti, _ = _entry_tiles(sites, tiles, sl, n_sites)
        f, b3, b5 = ED.k1_terms(srow, scol, mask, c)
        field.index_add_(0, ti, f)
        store(sl, b3, b5)
    return field.reshape(-1, 3)[:n_sites]


def fixed_field_and_scf_blocks_plain(sites, n_sites, tiles: TileList, c: ED.DirectConsts,
                                     chunk=CHUNK):
    """K1-bs's function in the Pallas kernel's layout: (field [n,3], s3
    [cap,256,256], s5 [cap,256,256]); the blocks of padded list entries
    come out zero. The reference of the line twin (tests, checks)."""
    s3 = sites.new_empty((tiles.capacity, TILE, TILE))
    s5 = torch.empty_like(s3)

    def store(sl, b3, b5):
        s3[sl], s5[sl] = b3, b5

    return _k1_plain(sites, n_sites, tiles, c, chunk, store), s3, s5


def fixed_field_and_scf_lines_plain(sites, n_sites, tiles: TileList, c: ED.DirectConsts,
                                    n_lines=None, chunk=CHUNK):
    """Plain twin of K1-bs: (field [n,3], ScfLines of capacity n_lines)
    holding the lines `live_lines` keeps, each chunk's blocks computed as
    in fixed_field_and_scf_blocks_plain (so lines_to_blocks of the result
    is that twin's blocks) and their live lines stored."""
    if n_lines is None:
        n_lines = default_line_capacity(sites.shape[0])
    live = live_lines(sites[:, :3], n_sites, tiles, c.box, c.cutoff)
    lines = _new_lines(sites.shape[0], n_lines, sites.dtype, sites.device, torch.zeros)
    slot, lines.count = line_slots(live, tiles)
    field = _k1_plain(sites, n_sites, tiles, c, chunk,
                      lambda sl, b3, b5: _put_lines(lines, b3, b5, live, slot, tiles, sl))
    return field, lines


def _k3_plain(sites, mu_pad, tiles: TileList, n_sites, c: ED.DirectConsts, chunk, blocks):
    """The dipole field [n,3] of K3-bs's formula; blocks(sl) gives the
    s3/s5 blocks [c, 256, 256] of the list entries sl."""
    n_tiles = sites.shape[0] // TILE
    st = sites.reshape(n_tiles, TILE, ED.NS)
    mt = mu_pad.reshape(n_tiles, TILE, 3)
    field = sites.new_zeros((n_tiles, TILE, 3))
    for sl in _chunks(tiles, chunk):
        ti, tj = tiles.ti[sl].long(), tiles.tj[sl].long()
        valid = ((tiles.meta[sl] & VALID) > 0)[:, None, None]
        delta = ED._delta(st[ti, :, :3], st[tj, :, :3], c.box)
        s3, s5 = blocks(sl)
        # the blocks of padded entries are unwritten in the Pallas layout:
        # select, do not multiply by zero
        field.index_add_(0, ti, torch.where(valid, dipole_field(mt[tj], s3, s5, delta), 0.0))
    return field.reshape(-1, 3)[:n_sites]


def scf_dipole_field_blocks_plain(sites, s3, s5, mu_pad, tiles: TileList, n_sites,
                                  c: ED.DirectConsts, chunk=CHUNK):
    """K3-bs's function on s3/s5 in the Pallas kernel's layout [cap, 256,
    256]: dipole field [n,3]; mu_pad [padded(n), 3] with zero padded rows.
    The reference of the line twin (tests)."""
    return _k3_plain(sites, mu_pad, tiles, n_sites, c, chunk, lambda sl: (s3[sl], s5[sl]))


def scf_dipole_field_bs_plain(sites, lines: ScfLines, mu_pad, tiles: TileList, n_sites,
                              c: ED.DirectConsts, chunk=CHUNK):
    """Plain twin of K3-bs: the dipole field [n,3] from the stored lines,
    each chunk's lines spread into its blocks (zeros elsewhere), so that it
    is bitwise scf_dipole_field_blocks_plain on lines_to_blocks(lines)."""
    index = _line_index(lines)
    return _k3_plain(sites, mu_pad, tiles, n_sites, c, chunk,
                     lambda sl: _expand(lines, index, sl))


def direct_energy_force_pot_bs_plain(sites, mu, n_sites, tiles: TileList,
                                     c: ED.DirectConsts, chunk=CHUNK):
    """Plain twin of K2-bs: (e_direct scalar, force [n,3], pot [n])."""
    n_tiles = sites.shape[0] // TILE
    mt = pad_rows(mu, sites.shape[0]).reshape(n_tiles, TILE, 3)
    out = sites.new_zeros((n_tiles, TILE, 5))
    for sl in _chunks(tiles, chunk):
        srow, scol, mask, ti, tj = _entry_tiles(sites, tiles, sl, n_sites)
        e_row, force, pot = ED.k2_terms(srow, scol, mask, mt[ti], mt[tj], c)
        out.index_add_(0, ti, torch.cat([force, pot[..., None], e_row[..., None]], dim=-1))
    out = out.reshape(-1, 5)[:n_sites]
    return torch.sum(out[:, 4]), out[:, :3], out[:, 3]


# ----------------------------------------------------------------------
# Kernel wrappers: CPU -> twin, CUDA float32 -> kernel, else raise
# ----------------------------------------------------------------------

def _check_sites(sites):
    if sites.dim() != 2 or sites.shape[1] != ED.NS or sites.shape[0] % TILE:
        raise ValueError(f'packed sites must be [k*{TILE}, {ED.NS}], got {tuple(sites.shape)}')


def _on_kernel(ints, *floats):
    """True when the call goes to the CUDA kernel (float tensors checked as
    in ops/elec_direct; the index tensors `ints` int32, contiguous, on the
    same device)."""
    if not ED._on_kernel(*floats):
        return False
    for t in ints:
        if t.device != floats[0].device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError('tile lists and line indices must be contiguous int32 tensors on '
                             'the sites\' device')
    return True


def _list_tensors(tiles: TileList):
    return tiles.ti, tiles.tj, tiles.meta, tiles.row_start


def _box_scratch(sites):
    """The kernels' scratch for the cluster boxes: [np_ / CLUSTER, 8]."""
    return torch.empty((sites.shape[0] // CLUSTER, 8), dtype=sites.dtype, device=sites.device)


def _list_args(tiles: TileList):
    return tiles.tj.data_ptr(), tiles.meta.data_ptr(), tiles.row_start.data_ptr()


def fixed_field_and_scf_lines(sites, n_sites, tiles: TileList, c: ED.DirectConsts,
                              n_lines=None):
    """K1-bs: (field [n,3], ScfLines of capacity n_lines, by default
    default_line_capacity) from padded packed sites [padded(n), 8] and an
    active tile-pair list. Only the live lines are written; lines.overflow()
    says whether a slab held more than n_lines."""
    _check_sites(sites)
    c.check_box()
    np_ = sites.shape[0]
    if n_lines is None:
        n_lines = default_line_capacity(np_)
    if not _on_kernel(_list_tensors(tiles), sites):
        return fixed_field_and_scf_lines_plain(sites, n_sites, tiles, c, n_lines)
    from mbpol_openmm_plugin_tpu_torch.ops import _build
    lib = _build.load()
    field = torch.empty((np_, 3), dtype=sites.dtype, device=sites.device)
    lines = _new_lines(np_, n_lines, sites.dtype, sites.device, torch.empty)
    boxes = _box_scratch(sites)
    ED._check(lib.mbpol_fixed_field_scf_bs(
        sites.data_ptr(), n_sites, np_ // TILE, *_list_args(tiles), *c.kernel_args(), n_lines,
        boxes.data_ptr(), field.data_ptr(), lines.s3.data_ptr(), lines.s5.data_ptr(),
        lines.entry.data_ptr(), lines.count.data_ptr(), ED._stream()),
        'fixed_field_and_scf_lines')
    fixed_field_and_scf_lines.launches += 1
    return field[:n_sites], lines


def scf_dipole_field_bs(sites, lines: ScfLines, mu_pad, tiles: TileList, n_sites,
                        c: ED.DirectConsts):
    """K3-bs: the dipole field [n,3] at the (sorted) sites from the lines
    K1-bs stored for them and mu_pad [padded(n), 3] (padded rows zero)."""
    _check_sites(sites)
    c.check_box()
    np_ = sites.shape[0]
    shape = (np_ // WATER, TILE // CLUSTER, lines.capacity, WATER, CLUSTER)
    if (tuple(mu_pad.shape) != (np_, 3) or tuple(lines.s3.shape) != shape
            or lines.s5.shape != lines.s3.shape or tuple(lines.entry.shape) != shape[:3]
            or tuple(lines.count.shape) != shape[:2]):
        raise ValueError(f'expected mu [{np_}, 3] and lines {shape}, got {tuple(mu_pad.shape)}, '
                         f'{tuple(lines.s3.shape)}, {tuple(lines.s5.shape)}, '
                         f'{tuple(lines.entry.shape)}, {tuple(lines.count.shape)}')
    if not _on_kernel(_list_tensors(tiles) + (lines.entry, lines.count), sites, lines.s3,
                      lines.s5, mu_pad):
        return scf_dipole_field_bs_plain(sites, lines, mu_pad, tiles, n_sites, c)
    from mbpol_openmm_plugin_tpu_torch.ops import _build
    lib = _build.load()
    field = torch.empty((np_, 3), dtype=sites.dtype, device=sites.device)
    ED._check(lib.mbpol_scf_field_bs(
        sites.data_ptr(), mu_pad.data_ptr(), np_ // TILE, tiles.tj.data_ptr(), *c.kernel_args(),
        lines.capacity, lines.s3.data_ptr(), lines.s5.data_ptr(), lines.entry.data_ptr(),
        lines.count.data_ptr(), field.data_ptr(), ED._stream()), 'scf_dipole_field_bs')
    scf_dipole_field_bs.launches += 1
    return field[:n_sites]


def direct_energy_force_pot_bs(sites, mu, n_sites, tiles: TileList, c: ED.DirectConsts):
    """K2-bs: (e_direct scalar, force [n,3], pot [n]) from padded packed
    sites and the induced dipoles mu [n,3] (in the sites' order)."""
    _check_sites(sites)
    c.check_box()
    if tuple(mu.shape) != (n_sites, 3):
        raise ValueError(f'expected mu [{n_sites}, 3], got {tuple(mu.shape)}')
    if not _on_kernel(_list_tensors(tiles), sites, mu):
        return direct_energy_force_pot_bs_plain(sites, mu, n_sites, tiles, c)
    from mbpol_openmm_plugin_tpu_torch.ops import _build
    lib = _build.load()
    np_ = sites.shape[0]
    mu_pad = pad_rows(mu, np_)
    force = torch.empty((np_, 3), dtype=sites.dtype, device=sites.device)
    pot = torch.empty((np_,), dtype=sites.dtype, device=sites.device)
    e_row = torch.empty((np_,), dtype=sites.dtype, device=sites.device)
    boxes = _box_scratch(sites)
    ED._check(lib.mbpol_direct_efp_bs(
        sites.data_ptr(), mu_pad.data_ptr(), n_sites, np_ // TILE, *_list_args(tiles),
        *c.kernel_args(), boxes.data_ptr(), force.data_ptr(), pot.data_ptr(), e_row.data_ptr(),
        ED._stream()), 'direct_energy_force_pot_bs')
    direct_energy_force_pot_bs.launches += 1
    return torch.sum(e_row[:n_sites]), force[:n_sites], pot[:n_sites]


fixed_field_and_scf_lines.launches = 0
scf_dipole_field_bs.launches = 0
direct_energy_force_pot_bs.launches = 0

KERNELS = (fixed_field_and_scf_lines, scf_dipole_field_bs, direct_energy_force_pot_bs)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
