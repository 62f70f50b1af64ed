"""Three-body term: short-range MB-pol trimer correction
(port of mbpol_openmm_plugin_tpu/models/three_body.py).

36 exponential variables over all intra/inter atom pairs feed the poly3b
polynomial (ops/polyeval.pip_apply); the switch product
s = sab*sac + sab*sbc + sac*sbc of cosine switches on [0, 4.5] A makes any
superset of the >=2-edge triplets give identical energies. Early exit if
any O-O distance < 2 A.
"""
import functools
import itertools

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch import _data
from mbpol_openmm_plugin_tpu_torch.models.two_body import (f_switch, image,
                                                           safe_norm)
from mbpol_openmm_plugin_tpu_torch.ops.gather import gather_rows
from mbpol_openmm_plugin_tpu_torch.ops.polyeval import pip_apply
from mbpol_openmm_plugin_tpu_torch.system import (System, box_tensor,
                                                  water_positions)
from mbpol_openmm_plugin_tpu_torch.utils import units

_RMIN = 2.0   # A


@functools.lru_cache(maxsize=None)
def _consts():
    return {k: float(v) for k, v in _data.load('threebody_constants').items()
            if np.ndim(v) == 0}


def _image_triplet(pos_a, pos_b, pos_c, box):
    """Each water's hydrogens w.r.t. its own O; Ob and Oc w.r.t. Oa."""
    oa = pos_a[..., 0, :]
    out = [torch.stack([oa, image(oa, pos_a[..., 1, :], box),
                        image(oa, pos_a[..., 2, :], box)], dim=-2)]
    for pos in (pos_b, pos_c):
        o = image(oa, pos[..., 0, :], box)
        out.append(torch.stack([o, image(o, pos[..., 1, :], box),
                                image(o, pos[..., 2, :], box)], dim=-2))
    return tuple(out)


def triplet_variables(pos_a, pos_b, pos_c, valid):
    """(polynomial variables x [T, 36], (rab, rac, rbc) [T] each, active [T])
    for monomer triplets [T, 3, 3] (Angstrom, imaged); `valid` [T] masks
    padded entries."""
    c = _consts()
    dt, dev = pos_a.dtype, pos_a.device
    oa, ha1, ha2 = pos_a[:, 0], pos_a[:, 1], pos_a[:, 2]

    rab = safe_norm(oa - pos_b[:, 0])
    rac = safe_norm(oa - pos_c[:, 0])
    rbc = safe_norm(pos_b[:, 0] - pos_c[:, 0])
    active = valid & (rab > _RMIN) & (rac > _RMIN) & (rbc > _RMIN)

    # substitute geometry for inactive entries (see two_body_energy_pairs)
    safe = ~active[:, None, None]
    pos_b = torch.where(safe, pos_a + torch.tensor([4.0, 0.0, 0.0], dtype=dt, device=dev), pos_b)
    pos_c = torch.where(safe, pos_a + torch.tensor([0.0, 4.0, 0.0], dtype=dt, device=dev), pos_c)
    ob, hb1, hb2 = pos_b[:, 0], pos_b[:, 1], pos_b[:, 2]
    oc, hc1, hc2 = pos_c[:, 0], pos_c[:, 1], pos_c[:, 2]

    def var(k, d0, p1, p2):
        return torch.exp(-k * (safe_norm(p1 - p2) - d0))

    kHHi, dHHi = c['kHH_intra'], c['dHH_intra']
    kOHi, dOHi = c['kOH_intra'], c['dOH_intra']
    kHH, dHH = c['kHH'], c['dHH']
    kOH, dOH = c['kOH'], c['dOH']
    kOO, dOO = c['kOO'], c['dOO']

    # variable layout mirrors MBPolReferenceThreeBodyForce.cpp:170-206
    x = torch.stack([
        var(kHHi, dHHi, ha1, ha2), var(kHHi, dHHi, hb1, hb2), var(kHHi, dHHi, hc1, hc2),
        var(kOHi, dOHi, oa, ha1), var(kOHi, dOHi, oa, ha2),
        var(kOHi, dOHi, ob, hb1), var(kOHi, dOHi, ob, hb2),
        var(kOHi, dOHi, oc, hc1), var(kOHi, dOHi, oc, hc2),
        var(kHH, dHH, ha1, hb1), var(kHH, dHH, ha1, hb2),
        var(kHH, dHH, ha1, hc1), var(kHH, dHH, ha1, hc2),
        var(kHH, dHH, ha2, hb1), var(kHH, dHH, ha2, hb2),
        var(kHH, dHH, ha2, hc1), var(kHH, dHH, ha2, hc2),
        var(kHH, dHH, hb1, hc1), var(kHH, dHH, hb1, hc2),
        var(kHH, dHH, hb2, hc1), var(kHH, dHH, hb2, hc2),
        var(kOH, dOH, oa, hb1), var(kOH, dOH, oa, hb2),
        var(kOH, dOH, oa, hc1), var(kOH, dOH, oa, hc2),
        var(kOH, dOH, ob, ha1), var(kOH, dOH, ob, ha2),
        var(kOH, dOH, ob, hc1), var(kOH, dOH, ob, hc2),
        var(kOH, dOH, oc, ha1), var(kOH, dOH, oc, ha2),
        var(kOH, dOH, oc, hb1), var(kOH, dOH, oc, hb2),
        var(kOO, dOO, oa, ob), var(kOO, dOO, oa, oc), var(kOO, dOO, ob, oc),
    ], dim=-1)
    return x, (rab, rac, rbc), active


def three_body_energy_triplets(pos_a, pos_b, pos_c, valid, pip=None):
    """Three-body energies [T] in kcal/mol for monomer triplets [T, 3, 3]
    (Angstrom, imaged); `valid` [T] masks padded entries; `pip`: optional
    (impl, basis) of the polynomial evaluator (MBPolConfig.pip_impl/
    pip_basis; None entries = the defaults)."""
    c = _consts()
    x, (rab, rac, rbc), active = triplet_variables(pos_a, pos_b, pos_c, valid)
    impl, basis = pip or (None, None)
    e_poly = pip_apply('poly3b', x, impl=impl, basis=basis)
    sab = f_switch(rab, c['r3i'], c['r3f'])
    sac = f_switch(rac, c['r3i'], c['r3f'])
    sbc = f_switch(rbc, c['r3i'], c['r3f'])
    s = sab * sac + sab * sbc + sac * sbc
    return torch.where(active, s * e_poly, 0.0)


def _imaged_triplets(system: System, positions, triplets, triplet_mask):
    """(pos_a, pos_b, pos_c [T, 3, 3] Angstrom, imaged; triplet_mask [T]) of
    the listed water triplets (default: all i<j<k)."""
    dev = positions.device
    wpos = water_positions(system, positions) * units.NM_TO_ANGSTROM
    if triplets is None:
        trip = list(itertools.combinations(range(system.n_waters), 3))
        triplets = torch.as_tensor(np.asarray(trip, np.int64).reshape(-1, 3), device=dev)
    if triplet_mask is None:
        triplet_mask = torch.ones(len(triplets), dtype=torch.bool, device=dev)
    wflat = wpos.reshape(-1, 9)
    pos_a = gather_rows(wflat, triplets[:, 0], triplet_mask).reshape(-1, 3, 3)
    pos_b = gather_rows(wflat, triplets[:, 1], triplet_mask).reshape(-1, 3, 3)
    pos_c = gather_rows(wflat, triplets[:, 2], triplet_mask).reshape(-1, 3, 3)
    if system.periodic:
        box_a = box_tensor(system.box, positions) * units.NM_TO_ANGSTROM
        pos_a, pos_b, pos_c = _image_triplet(pos_a, pos_b, pos_c, box_a)
    return pos_a, pos_b, pos_c, triplet_mask


def three_body_variables(system: System, positions, triplets=None, triplet_mask=None):
    """The polynomial variables x [T, 36] that `three_body_energy` evaluates
    for these arguments (padded entries hold the substitute geometry)."""
    return triplet_variables(*_imaged_triplets(system, positions, triplets, triplet_mask))[0]


def three_body_energy(system: System, positions, triplets=None, triplet_mask=None, pip=None):
    """Total three-body energy in kJ/mol.

    triplets: optional [T, 3] integer tensor of water index triplets
    (default: all i<j<k); triplet_mask: optional [T] bool; pip: optional
    (impl, basis) of the polynomial evaluator.
    """
    e_kcal = three_body_energy_triplets(
        *_imaged_triplets(system, positions, triplets, triplet_mask), pip=pip)
    return torch.sum(e_kcal) * units.KCAL_PER_MOL_TO_KJ_PER_MOL
