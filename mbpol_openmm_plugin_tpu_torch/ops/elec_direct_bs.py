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

K1-bs `fixed_field_and_scf_blocks` replaces the Pallas kernel
`_fixed_field_bs_kernel`: fixed-field rows and the s3/s5 factor BLOCKS
[cap, 256, 256] (O(N) memory at fixed density).
K3-bs `scf_dipole_field_bs` replaces `_scf_field_bs_kernel`: one SCF
dipole-field evaluation over the stored blocks.
K2-bs `direct_energy_force_pot_bs` replaces `_pair_force_bs_kernel`:
direct-space energy, forces and per-site potential.
K3-bs and K2-bs cull at warp granularity: a (row water, 32-site column
cluster) line of an active block is skipped when the minimum-image gap
between the two groups' boxes exceeds the cutoff (`group_boxes`,
`live_lines` are the plain twin of that test; the kernels compute the
boxes on the card).

Dispatch, as in ops/elec_direct.py: CPU tensors go to the plain twins
(`*_plain`), CUDA float32 tensors to the kernels, anything else raises;
there is no fallback. The twins gather [chunk, 256, 8] row and column
tiles per list entry and run the formulas of ops/elec_direct.k1_terms /
k2_terms on [chunk, 256, 256], so they also run at water4096 on the card
(chip_smoke.py and the cuda tests compare the kernels with them). Each
kernel wrapper counts its launches in its `launches` attribute. What
bounds the kernels on the H100 and their design: csrc/elec_direct_bs.cu.

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
    b = torch.as_tensor(np.asarray(box, np.float64), dtype=dt, device=dev)
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
    b = torch.as_tensor(np.asarray(box, np.float64), dtype=dt, device=dev)
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
    b = torch.as_tensor(np.asarray(box, np.float64), dtype=xyz.dtype, device=xyz.device)
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
    b = torch.as_tensor(np.asarray(box, np.float64), dtype=xyz.dtype, device=xyz.device)
    rc, rh = (x.reshape(-1, TILE // WATER, 3) for x in group_boxes(xyz, n_sites, box, WATER))
    cc, ch = (x.reshape(-1, TILE // CLUSTER, 3) for x in group_boxes(xyz, n_sites, box, CLUSTER))
    ti, tj = tiles.ti.long(), tiles.tj.long()
    dc = cc[tj][:, None, :, :] - rc[ti][:, :, None, :]
    dc = dc - torch.floor(dc / b + 0.5) * b
    gap = torch.clamp(dc.abs() - (rh[ti][:, :, None, :] + ch[tj][:, None, :, :]), min=0.0)
    valid = ((tiles.meta & VALID) > 0)[:, None, None]
    return (torch.sum(gap * gap, dim=-1) <= cutoff * cutoff) & valid


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


def fixed_field_and_scf_blocks_plain(sites, n_sites, tiles: TileList, c: ED.DirectConsts,
                                     chunk=CHUNK):
    """Plain twin of K1-bs: (field [n,3], s3 [cap,256,256], s5 [cap,256,256]);
    the blocks of padded list entries come out zero."""
    n_tiles = sites.shape[0] // TILE
    field = sites.new_zeros((n_tiles, TILE, 3))
    s3 = sites.new_empty((tiles.capacity, TILE, TILE))
    s5 = torch.empty_like(s3)
    for sl in _chunks(tiles, chunk):
        srow, scol, mask, ti, _ = _entry_tiles(sites, tiles, sl, n_sites)
        f, s3[sl], s5[sl] = ED.k1_terms(srow, scol, mask, c)
        field.index_add_(0, ti, f)
    return field.reshape(-1, 3)[:n_sites], s3, s5


def scf_dipole_field_bs_plain(sites, s3, s5, mu_pad, tiles: TileList, n_sites,
                              c: ED.DirectConsts, chunk=CHUNK):
    """Plain twin of K3-bs: dipole field [n,3] from the blocks; mu_pad
    [padded(n), 3] with zero padded rows."""
    n_tiles = sites.shape[0] // TILE
    st = sites.reshape(n_tiles, TILE, ED.NS)
    mt = mu_pad.reshape(n_tiles, TILE, 3)
    field = sites.new_zeros((n_tiles, TILE, 3))
    for sl in _chunks(tiles, chunk):
        ti, tj = tiles.ti[sl].long(), tiles.tj[sl].long()
        valid = ((tiles.meta[sl] & VALID) > 0)[:, None, None]
        delta = ED._delta(st[ti, :, :3], st[tj, :, :3], c.box)
        # the blocks of padded entries are unwritten by K1-bs: select, do
        # not multiply by zero
        field.index_add_(0, ti, torch.where(valid, dipole_field(mt[tj], s3[sl], s5[sl], delta),
                                            0.0))
    return field.reshape(-1, 3)[:n_sites]


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


def _on_kernel(tiles: TileList, *floats):
    """True when the call goes to the CUDA kernel (float tensors checked as
    in ops/elec_direct; list tensors int32, contiguous, on the same
    device)."""
    if not ED._on_kernel(*floats):
        return False
    for t in (tiles.ti, tiles.tj, tiles.meta, tiles.row_start):
        if t.device != floats[0].device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError('tile lists must be contiguous int32 tensors on the sites\' device')
    return True


def _box_scratch(sites):
    """The kernels' scratch for the cluster boxes: [np_ / CLUSTER, 8]."""
    return torch.empty((sites.shape[0] // CLUSTER, 8), dtype=sites.dtype, device=sites.device)


def _list_args(tiles: TileList):
    return tiles.tj.data_ptr(), tiles.meta.data_ptr(), tiles.row_start.data_ptr()


def fixed_field_and_scf_blocks(sites, n_sites, tiles: TileList, c: ED.DirectConsts):
    """K1-bs: (field [n,3], s3 [cap,256,256], s5 [cap,256,256]) from padded
    packed sites [padded(n), 8] and an active tile-pair list. The blocks of
    padded list entries (VALID clear) are left unwritten; their readers
    skip them."""
    _check_sites(sites)
    if not _on_kernel(tiles, sites):
        return fixed_field_and_scf_blocks_plain(sites, n_sites, tiles, c)
    from mbpol_openmm_plugin_tpu_torch.ops import _build
    lib = _build.load()
    np_, cap = sites.shape[0], tiles.capacity
    field = torch.empty((np_, 3), dtype=sites.dtype, device=sites.device)
    s3 = torch.empty((cap, TILE, TILE), dtype=sites.dtype, device=sites.device)
    s5 = torch.empty_like(s3)
    ED._check(lib.mbpol_fixed_field_scf_bs(
        sites.data_ptr(), n_sites, np_ // TILE, *_list_args(tiles), *c.kernel_args(),
        field.data_ptr(), s3.data_ptr(), s5.data_ptr(), ED._stream()),
        'fixed_field_and_scf_blocks')
    fixed_field_and_scf_blocks.launches += 1
    return field[:n_sites], s3, s5


def scf_dipole_field_bs(sites, s3, s5, mu_pad, tiles: TileList, n_sites, c: ED.DirectConsts):
    """K3-bs: the dipole field [n,3] at the (sorted) sites from the stored
    s3/s5 blocks and mu_pad [padded(n), 3] (padded rows zero)."""
    _check_sites(sites)
    np_, cap = sites.shape[0], tiles.capacity
    if tuple(mu_pad.shape) != (np_, 3) or tuple(s3.shape) != (cap, TILE, TILE) \
            or s5.shape != s3.shape:
        raise ValueError(f'expected mu [{np_}, 3] and blocks [{cap}, {TILE}, {TILE}], got '
                         f'{tuple(mu_pad.shape)}, {tuple(s3.shape)}, {tuple(s5.shape)}')
    if not _on_kernel(tiles, sites, s3, s5, mu_pad):
        return scf_dipole_field_bs_plain(sites, s3, s5, mu_pad, tiles, n_sites, c)
    from mbpol_openmm_plugin_tpu_torch.ops import _build
    lib = _build.load()
    field = torch.empty((np_, 3), dtype=sites.dtype, device=sites.device)
    boxes = _box_scratch(sites)
    ED._check(lib.mbpol_scf_field_bs(
        sites.data_ptr(), mu_pad.data_ptr(), n_sites, np_ // TILE, *_list_args(tiles),
        *c.kernel_args(), s3.data_ptr(), s5.data_ptr(), boxes.data_ptr(), field.data_ptr(),
        ED._stream()), 'scf_dipole_field_bs')
    scf_dipole_field_bs.launches += 1
    return field[:n_sites]


def direct_energy_force_pot_bs(sites, mu, n_sites, tiles: TileList, c: ED.DirectConsts):
    """K2-bs: (e_direct scalar, force [n,3], pot [n]) from padded packed
    sites and the induced dipoles mu [n,3] (in the sites' order)."""
    _check_sites(sites)
    if tuple(mu.shape) != (n_sites, 3):
        raise ValueError(f'expected mu [{n_sites}, 3], got {tuple(mu.shape)}')
    if not _on_kernel(tiles, sites, mu):
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


fixed_field_and_scf_blocks.launches = 0
scf_dipole_field_bs.launches = 0
direct_energy_force_pot_bs.launches = 0

KERNELS = (fixed_field_and_scf_blocks, scf_dipole_field_bs, direct_energy_force_pot_bs)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
