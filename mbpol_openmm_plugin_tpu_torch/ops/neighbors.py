"""Padded O-O pair and triplet lists built on the device
(port of mbpol_openmm_plugin_tpu/ops/neighbors.py).

Fixed-capacity index lists from masked distance matrices: static shapes,
no host sync inside the build, overflow surfaced through `n_found`.

Triplet semantics ('complete'): all unordered triplets with >= 2 O-O edges
(the full support of the 3-body switch product), each enumerated once via
its center j: candidate (i, j, k) with i < k both neighbors of j is kept
unless it is a triangle whose smallest vertex is not j.

Not ported yet: the 'reference' triplet semantics and the compact_* list
compaction (see ROADMAP.md).
"""
from __future__ import annotations

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch.system import minimum_image


def pair_capacity(n_mol, box, cutoff, factor=1.5, floor=64):
    """Static capacity estimate for the O-O pair list."""
    if box is None:
        return n_mol * (n_mol - 1) // 2
    vol = float(np.prod(np.asarray(box)))
    per = n_mol / vol * 4.0 / 3.0 * np.pi * cutoff ** 3
    est = int(factor * n_mol * per / 2) + floor
    return min(est, n_mol * (n_mol - 1) // 2)


def max_neighbors(n_mol, box, cutoff, factor=2.0, floor=16):
    if box is None:
        return n_mol - 1
    vol = float(np.prod(np.asarray(box)))
    per = n_mol / vol * 4.0 / 3.0 * np.pi * cutoff ** 3
    return min(int(factor * per) + floor, n_mol - 1)


def triplet_capacity(n_mol, box, cutoff, factor=1.5, floor=128):
    if box is None:
        return n_mol * (n_mol - 1) * (n_mol - 2) // 6
    k = max_neighbors(n_mol, box, cutoff, factor=1.0, floor=0)
    est = int(factor * n_mol * k * max(k - 1, 1) / 2) + floor
    return min(est, n_mol * (n_mol - 1) * (n_mol - 2) // 6)


def _edge_matrix(o_pos, box, cutoff):
    d = minimum_image(o_pos[None, :, :] - o_pos[:, None, :], box)
    r2 = torch.sum(d * d, dim=-1)
    n = o_pos.shape[0]
    return (r2 < cutoff * cutoff) & ~torch.eye(n, dtype=torch.bool, device=o_pos.device)


def _first_true(flags, size):
    """Positions of the first `size` True entries of a 1-D bool tensor in
    ascending order (a static-size nonzero), and the count of True."""
    order = torch.argsort((~flags).to(torch.int8), stable=True)[:size]
    if order.numel() < size:
        order = torch.cat([order, order.new_zeros(size - order.numel())])
    count = torch.sum(flags)
    valid = torch.arange(size, device=flags.device) < count
    return torch.where(valid, order, 0), valid, count


def pair_list(o_pos, box, cutoff, capacity):
    """Padded i<j pair list: (pairs [capacity, 2] int64, mask [capacity],
    n_found). Padded rows hold (0, 0)."""
    n = o_pos.shape[0]
    edge = _edge_matrix(o_pos, box, cutoff)
    ar = torch.arange(n, device=o_pos.device)
    upper = (edge & (ar[:, None] < ar[None, :])).reshape(-1)
    flat, mask, n_found = _first_true(upper, capacity)
    return torch.stack([flat // n, flat % n], dim=1), mask, n_found


def _triplet_candidates(edge, k_max):
    """Per-center candidate block: (order [n, K], the K first neighbors of
    each center j in ascending index order; keep [n, K, K], the kept
    triplets (order[j, p], j, order[j, q]) with p < q)."""
    n, dev = edge.shape[0], edge.device
    order = torch.argsort((~edge).to(torch.int8), dim=1, stable=True)[:, :k_max]
    valid = torch.gather(edge, 1, order)                            # [n, K]

    centers = torch.arange(n, device=dev)[:, None, None]            # j
    i_idx = order[:, :, None]                                       # [n, K, 1]
    k_idx = order[:, None, :]                                       # [n, 1, K]
    ar = torch.arange(k_max, device=dev)
    pq_upper = (ar[:, None] < ar[None, :])[None]
    cand = valid[:, :, None] & valid[:, None, :] & pq_upper         # i < k
    ik_edge = edge[i_idx, k_idx]
    return order, cand & (~ik_edge | (centers < i_idx))


def neighbor_counts(o_pos, box, cutoff, triplets=False):
    """Exact counts for capacity tuning, from the same edge matrix as the
    builders: (pairs i<j within the cutoff, neighbors per molecule [n],
    and with triplets=True the 'complete' triplets per center [n], else
    None). Reads the counts on the host."""
    edge = _edge_matrix(o_pos, box, cutoff)
    degree = torch.sum(edge, dim=1)
    per_center = None
    if triplets:
        k_max = int(torch.max(degree)) if edge.shape[0] else 0
        per_center = (torch.zeros_like(degree) if k_max < 2 else
                      torch.sum(_triplet_candidates(edge, k_max)[1], dim=(1, 2)))
    return int(torch.sum(degree)) // 2, degree, per_center


def triplet_list(o_pos, box, cutoff, capacity, k_max=None, kt=None):
    """Padded 'complete' triplet list (see module docstring).

    Two-stage selection as in the JAX package: stage 1 compacts each
    center's [K, K] candidate block to `kt` slots, stage 2 places every
    center's run at its exclusive-cumsum offset. A per-center truncation
    (kt or k_max too small) is folded into n_found > capacity.

    Returns (triplets [capacity, 3] int64 as (i, center, k), mask, n_found).
    """
    n = o_pos.shape[0]
    dev = o_pos.device
    if k_max is None:
        k_max = max_neighbors(n, box, cutoff)
    max_kt = k_max * (k_max - 1) // 2
    if max_kt == 0:          # n < 3 or k_max < 2: no triplets possible
        return (torch.zeros((capacity, 3), dtype=torch.int64, device=dev),
                torch.zeros((capacity,), dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    kt = max_kt if kt is None else min(int(kt), max_kt)
    edge = _edge_matrix(o_pos, box, cutoff)
    order, keep = _triplet_candidates(edge, k_max)

    # stage 1: per-center compaction (kept (p, q) flat offsets, ascending)
    flat = keep.reshape(n, k_max * k_max)
    t_j = torch.sum(flat, dim=1)                                    # [n]
    iota = torch.arange(k_max * k_max, device=dev)[None]
    sentinel = torch.where(flat, iota, k_max * k_max)
    local = torch.sort(sentinel, dim=1).values[:, :kt]              # [n, kt]

    # stage 2: each center's run starts at its exclusive-cumsum offset
    off = torch.cat([torch.zeros(1, dtype=t_j.dtype, device=dev), torch.cumsum(t_j, 0)])
    n_found = off[-1]
    s = torch.arange(capacity, device=dev)
    jj = torch.clamp_max(torch.searchsorted(off[1:], s, right=True), n - 1)
    mask = s < n_found
    r = torch.where(mask, s - off[jj], 0)
    rem = local[jj, torch.clamp_max(r, kt - 1)]
    pi = torch.clamp_max(rem // k_max, k_max - 1)
    pk = torch.clamp_max(rem % k_max, k_max - 1)
    trip = torch.stack([order[jj, pi], jj, order[jj, pk]], dim=1)
    trip = torch.where(mask[:, None], trip, 0)
    if kt < max_kt:
        # per-center truncation would silently drop triplets
        n_found = torch.where(torch.max(t_j) > kt,
                              torch.clamp_min(n_found, capacity + 1), n_found)
    if k_max < n - 1:
        # a center with more than k_max neighbors loses candidates
        n_found = torch.where(torch.max(torch.sum(edge, dim=1)) > k_max,
                              torch.clamp_min(n_found, capacity + 1), n_found)
    mask = torch.arange(capacity, device=dev) < torch.clamp_max(n_found, capacity)
    return trip, mask, n_found
