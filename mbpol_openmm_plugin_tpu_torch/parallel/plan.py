"""Capacity planning (port of mbpol_openmm_plugin_tpu/parallel/plan.py):
what an (n_devices, N)-water run looks like before anything runs on the
device.

The padded lists have fixed capacities, sized before the first evaluation:
the pair and triplet lists, the compacted batches, the water-pair list of
the sparse electrostatics and the 'pairs' dispersion, the block layout
(site sort, tile-pair capacity, s3/s5 line capacity), the PME grid, and an
estimate of the working set from the port's own layouts. MBPol's
`tune_capacities` does this for a live potential; the planner does the
same arithmetic alone: from analytic density bounds when no positions
exist yet, or from exact host voxel-hash counts (ops/native.py) when they
do. `MBPol(system, config, mesh=mesh, plan=plan)` takes the result; for a
mesh of n_devices shards every list capacity is a multiple of n_devices,
the block layout has a per-shard local tile-pair capacity, and
`per_device()` gives each shard's rows.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch.models.dispersion import PAIR_MARGIN
from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as bs
from mbpol_openmm_plugin_tpu_torch.ops import neighbors

# the working-set estimate's per-row planes: the quadratic-form PIP basis
# m2, m2 @ W and their gradients (ops/polyeval.py), float32
PIP_BASIS = {'pairs': 528, 'triplets': 703}
PIP_PLANES = 4
# sparse electrostatics: [P, 4, 4] planes kept through the SCF and the
# forces (delta x 3, r, 1/r powers x 4, bn0..bn3, the Thole scales x 7,
# the SCF factors x 2, ...), float32
SPARSE_PLANES = 28
F32 = 4


@dataclasses.dataclass
class CapacityPlan:
    """Static shape parameters of an n_waters run on n_devices shards."""
    n_waters: int
    n_devices: int
    box: tuple
    elec_mode: str
    disp_mode: str
    pair_cap: int
    trip_cap: int
    # compacted batches: at the physical cutoffs, or + skin / 2 under
    # compact_eval='rebuild'
    pair_eval_cap: int
    trip_eval_cap: int
    nlist_k_max: int
    nlist_kt: Optional[int]
    elec_pair_cap: Optional[int]          # sparse mode (shared with 'pairs' dispersion)
    disp_pair_cap: Optional[int]          # 'pairs' dispersion with a list of its own
    tile_pair_capacity: Optional[int]     # block mode (global)
    tile_pair_capacity_local: Optional[int]   # block mode, per shard (n_devices > 1)
    line_capacity: Optional[int]          # block mode: s3/s5 lines per (row water, cluster)
    site_perm: Optional[np.ndarray]       # block mode: the sorted layout
    pme_grid: Optional[tuple]
    exact: bool                           # counts from positions, else analytic bounds
    mem_per_device_mb: float

    def per_device(self):
        """Each shard's rows: pair and triplet rows, sites of the padded
        dense direct space, and the sparse water-pair rows and local tile
        pairs where they apply."""
        from mbpol_openmm_plugin_tpu_torch.parallel.mesh import padded_for_mesh
        nd = self.n_devices
        out = dict(pair_rows=self.pair_cap // nd, triplet_rows=self.trip_cap // nd,
                   sites=padded_for_mesh(4 * self.n_waters, nd) // nd)
        if self.elec_pair_cap:
            out['elec_pair_rows'] = self.elec_pair_cap // nd
        if self.tile_pair_capacity_local:
            out['elec_tile_pairs_local'] = self.tile_pair_capacity_local
        return out

    def describe(self):
        lines = [
            f'plan: water{self.n_waters} on {self.n_devices} device(s), box '
            f'{tuple(round(float(b), 3) for b in self.box)} nm '
            f'({"exact counts" if self.exact else "analytic bounds"})',
            f'  electrostatics mode: {self.elec_mode}   dispersion: {self.disp_mode}   '
            f'PME grid: {self.pme_grid}',
            f'  pair capacity {self.pair_cap}  triplet capacity {self.trip_cap}  '
            f'(k_max {self.nlist_k_max}, kt {self.nlist_kt})',
            f'  eval buffers (compacted batches): pairs {self.pair_eval_cap}  triplets '
            f'{self.trip_eval_cap}']
        if self.elec_pair_cap:
            lines.append(f'  water-pair capacity {self.elec_pair_cap}')
        if self.tile_pair_capacity:
            lines.append(f'  elec tile pairs {self.tile_pair_capacity} (local/device '
                         f'{self.tile_pair_capacity_local}), s3/s5 lines per slab '
                         f'{self.line_capacity}')
        lines.append('  per device: ' + '  '.join(f'{k}={v}' for k, v in self.per_device().items()))
        lines.append(f'  est. working set ~{self.mem_per_device_mb:.0f} MB/device (float32: '
                     'direct space, PIP batches, PME grid pieces)')
        return '\n'.join(lines)

    def apply(self, pot):
        """Deprecated: build the potential with the plan instead,
        ``MBPol(system, config, device=..., plan=plan)``. Returns that new
        potential (pot is not changed)."""
        warnings.warn('CapacityPlan.apply(pot) is deprecated; pass the plan to the '
                      'constructor: MBPol(system, config, device=device, plan=plan)',
                      DeprecationWarning, stacklevel=2)
        return type(pot)(pot.system, pot.config, device=pot.device, mesh=pot.mesh, plan=self)


def _pme_grid(cfg, box):
    """PmeSetup.from_config's grid (OpenMM calcPMEParameters)."""
    if cfg.pme_grid is not None:
        return tuple(int(g) for g in cfg.pme_grid)
    tol = cfg.ewald_error_tolerance
    alpha = cfg.ewald_alpha or float(np.sqrt(-np.log(2.0 * tol)) / cfg.cutoff)
    return tuple(int(np.ceil(2.0 * alpha * b / (3.0 * tol ** 0.2))) for b in box)


def working_set_mb(mode, n_waters, pair_eval_cap, trip_eval_cap, pme_grid,
                   elec_pair_cap=None, tile_pair_capacity=None, line_capacity=None,
                   n_devices=1, tile_pair_capacity_local=None):
    """The dominant float32 terms of one evaluation's working set on one
    shard (MB), from the port's layouts: the direct space (dense: s3, s5
    and delta over the shard's rows [N_pad / n_devices, N_pad]; block: s3/s5
    as live lines [np / 4, TILE / CLUSTER, L, 4, CLUSTER] of the shard's
    rows and its tile-pair list; sparse: the shard's [P, 4, 4] planes), the
    shard's compacted PIP batches, and the PME pieces (the three
    [N, n_axis, 3] spline matrices of its sites, the real and complex
    grids, the chunked spread and read-back temporaries)."""
    from mbpol_openmm_plugin_tpu_torch.parallel.mesh import padded_for_mesh
    n, nd = 4 * n_waters, n_devices
    b = 0
    if mode == 'dense':
        n_pad = n if nd == 1 else padded_for_mesh(n, nd)
        b += 5 * (n_pad // nd) * n_pad * F32
    elif mode == 'block':
        n_pad = bs.padded(n) if nd == 1 else padded_for_mesh(n, nd)
        b += 2 * (n_pad // nd // bs.WATER) * (bs.TILE // bs.CLUSTER) * line_capacity \
            * bs.WATER * bs.CLUSTER * F32
        b += 3 * (tile_pair_capacity_local or tile_pair_capacity) * 4   # ti, tj, meta: int32
    elif mode == 'sparse':
        b += elec_pair_cap // nd * 16 * SPARSE_PLANES * F32
    b += pair_eval_cap // nd * PIP_BASIS['pairs'] * PIP_PLANES * F32
    b += trip_eval_cap // nd * PIP_BASIS['triplets'] * PIP_PLANES * F32
    if pme_grid:
        from mbpol_openmm_plugin_tpu_torch.models.pme import _NDERIV, _SEP_CHUNK_ELEMS
        nx, ny, nz = pme_grid
        n = -(-n // nd)
        b += 3 * n * max(pme_grid) * _NDERIV * F32
        b += nx * ny * nz * (F32 + 2 * F32)
        b += min(3 * n * ny * nz, _SEP_CHUNK_ELEMS) * F32 + min(n * _NDERIV * nx * ny,
                                                              _SEP_CHUNK_ELEMS) * F32
    return b / 1e6


def plan_capacities(n_waters, box, n_devices=1, config=None, positions=None, margin=1.15,
                    device='cuda'):
    """Size every static shape of an n_waters run in `box` on n_devices
    shards (a parallel.mesh.Mesh of that size).

    positions: optional [4 n_waters, 3] nm (numpy or tensor; M sites
    placed): the pair and triplet counts then come from the host voxel
    hash at these positions (MBPol.tune_capacities' arithmetic: margin x
    the count + slack) and the block layout from the port's tile and line
    counts on `device`; otherwise from the analytic density bounds.
    device: where the potential will run ('cuda' or 'cpu'; a mesh's lead):
    it resolves 'auto' as MBPol does (block above 2560 x max(n_devices //
    2, 1) waters with the card's kernels, sparse above 512 without). Every
    list capacity is rounded up to a multiple of n_devices, as the JAX
    planner does."""
    from mbpol_openmm_plugin_tpu_torch.models import potential as P
    from mbpol_openmm_plugin_tpu_torch.parallel.mesh import round_up
    from mbpol_openmm_plugin_tpu_torch.system import (System, make_molecules_whole,
                                                      oxygen_positions)
    n_devices = int(n_devices)
    if n_devices < 1:
        raise ValueError(f'n_devices must be >= 1, got {n_devices}')
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("plan_capacities: no CUDA device is available; pass device='cpu'")
    cfg = config or P.MBPolConfig(nonbonded_method='PME', cutoff=0.9, nlist_skin=0.02)
    box = np.asarray(box, np.float64)
    system = System.waters(int(n_waters), box=box)
    mode, dmode = P.resolve_modes(system, cfg, cfg.nonbonded_method == 'PME',
                                  kernels=device.type == 'cuda', n_devices=n_devices)
    skin, f = cfg.nlist_skin, cfg.neighbor_capacity_factor
    half = 0.5 * skin if cfg.compact_eval == 'rebuild' else 0.0
    exact = positions is not None
    site_perm = tile_cap = line_cap = tile_cap_local = None
    if exact:
        dtype = torch.float32 if device.type == 'cuda' else torch.float64
        pos = make_molecules_whole(system, torch.as_tensor(positions, dtype=dtype,
                                                           device=device))
        counts = P.ListCounts(oxygen_positions(system, pos), system.box, native=True)
        caps = P.list_capacities(counts, cfg, n_waters, margin, mode, dmode == 'pairs')
        if mode == 'block':
            site_perm, tile_cap, line_cap, tile_cap_local = P.block_layout(
                system, pos, system.box, cfg.cutoff, margin, n_devices if n_devices > 1 else None)
    else:
        pair_cap = neighbors.pair_capacity(n_waters, box, cfg.cutoff_2b + skin, factor=f)
        trip_cap = neighbors.triplet_capacity(n_waters, box, cfg.cutoff_3b + skin, factor=f)
        caps = dict(
            pair_cap=pair_cap, trip_cap=trip_cap,
            nlist_k_max=neighbors.max_neighbors(n_waters, box, cfg.cutoff_3b + skin),
            nlist_kt=None,
            pair_eval_cap=min(neighbors.pair_capacity(n_waters, box, cfg.cutoff_2b + half,
                                                      factor=f), pair_cap),
            trip_eval_cap=min(neighbors.triplet_capacity(n_waters, box, cfg.cutoff_3b + half,
                                                         factor=f), trip_cap),
            elec_pair_cap=None, disp_pair_cap=None)
        if mode == 'sparse' or dmode == 'pairs':
            cap = neighbors.pair_capacity(n_waters, box, cfg.cutoff + PAIR_MARGIN + skin,
                                          factor=f)
            caps['elec_pair_cap' if mode == 'sparse' else 'disp_pair_cap'] = cap
        if mode == 'block':
            n_sites = 4 * n_waters
            tile_cap = bs.tile_pair_capacity(n_sites, box, cfg.cutoff)
            line_cap = bs.default_line_capacity(bs.padded(n_sites))
            if n_devices > 1:
                tile_cap_local = max(round_up(tile_cap, n_devices) // n_devices + 8, 16)
    for name in ('pair_cap', 'trip_cap', 'pair_eval_cap', 'trip_eval_cap', 'elec_pair_cap',
                 'disp_pair_cap'):
        if caps[name] is not None:
            caps[name] = round_up(caps[name], n_devices)
    pme_grid = _pme_grid(cfg, box) if cfg.nonbonded_method == 'PME' else None
    mb = working_set_mb(mode, n_waters, caps['pair_eval_cap'], caps['trip_eval_cap'], pme_grid,
                        caps['elec_pair_cap'], tile_cap, line_cap, n_devices, tile_cap_local)
    return CapacityPlan(
        n_waters=int(n_waters), n_devices=n_devices, box=tuple(float(b) for b in box),
        elec_mode=mode,
        disp_mode=dmode, pair_cap=int(caps['pair_cap']), trip_cap=int(caps['trip_cap']),
        pair_eval_cap=int(caps['pair_eval_cap']), trip_eval_cap=int(caps['trip_eval_cap']),
        nlist_k_max=int(caps['nlist_k_max']),
        nlist_kt=None if caps['nlist_kt'] is None else int(caps['nlist_kt']),
        elec_pair_cap=caps['elec_pair_cap'], disp_pair_cap=caps['disp_pair_cap'],
        tile_pair_capacity=tile_cap, tile_pair_capacity_local=tile_cap_local,
        line_capacity=line_cap, site_perm=site_perm,
        pme_grid=pme_grid, exact=exact, mem_per_device_mb=float(mb))
