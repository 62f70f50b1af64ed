"""Two-body term: short-range MB-pol dimer correction
(port of mbpol_openmm_plugin_tpu/models/two_body.py).

Active for 2 A < rOO <= 6.5 A with a cosine switch on rOO in [4.5, 6.5] A;
31 exponential/coulomb-type variables over atom and lone-pair sites feed
the poly2b polynomial (ops/polyeval.pip_apply). Forces come from autograd
of the energy.
"""
import functools

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch import _data
from mbpol_openmm_plugin_tpu_torch.ops.gather import gather_rows
from mbpol_openmm_plugin_tpu_torch.ops.polyeval import pip_apply
from mbpol_openmm_plugin_tpu_torch.system import (System, box_tensor,
                                                  water_positions)
from mbpol_openmm_plugin_tpu_torch.utils import units

_D0_INTRA = 1.0   # A
_D0_INTER = 4.0   # A
_RMIN = 2.0       # A early exit


@functools.lru_cache(maxsize=None)
def _consts():
    return {k: float(v) for k, v in _data.load('twobody_constants').items()
            if np.ndim(v) == 0}


def f_switch(r, r_lo, r_hi):
    """Cosine switching function, 1 below r_lo, 0 above r_hi."""
    x = (r - r_lo) * (np.pi / (r_hi - r_lo))
    s = (1.0 + torch.cos(x)) / 2.0
    return torch.where(r > r_hi, 0.0, torch.where(r > r_lo, s, 1.0))


def image(ref, p, box):
    """p imaged next to ref (reference imageParticles convention)."""
    return p + torch.floor((ref - p) / box + 0.5) * box


def _image_pair(pos_a, pos_b, box):
    """Hydrogens imaged w.r.t. their own oxygen, the second oxygen w.r.t.
    the first. Angstrom in/out."""
    oa = pos_a[..., 0, :]
    ob = image(oa, pos_b[..., 0, :], box)
    return (torch.stack([oa, image(oa, pos_a[..., 1, :], box),
                         image(oa, pos_a[..., 2, :], box)], dim=-2),
            torch.stack([ob, image(ob, pos_b[..., 1, :], box),
                         image(ob, pos_b[..., 2, :], box)], dim=-2))


def monomer_extra_points(o, h1, h2, in_plane_g, out_of_plane_g):
    """Lone-pair sites. Angstrom in/out."""
    oh1 = h1 - o
    oh2 = h2 - o
    v = torch.cross(oh1, oh2, dim=-1)
    in_plane = o + (oh1 + oh2) * (0.5 * in_plane_g)
    out_of_plane = v * out_of_plane_g
    return in_plane + out_of_plane, in_plane - out_of_plane


def safe_norm(d, eps=1e-12):
    return torch.sqrt(torch.clamp_min(torch.sum(d * d, dim=-1), eps))


def pair_variables(pos_a, pos_b, valid):
    """(polynomial variables x [P, 31], rOO [P], active [P]) for monomer
    pairs [P, 3, 3] (Angstrom, already imaged); `valid` [P] masks padded
    entries."""
    c = _consts()
    oa, ha1, ha2 = pos_a[:, 0], pos_a[:, 1], pos_a[:, 2]

    roo = safe_norm(oa - pos_b[:, 0])
    active = valid & (roo < c['r2f']) & (roo > _RMIN)

    # Inactive entries (padding, r < 2 A) get a well-separated substitute
    # geometry BEFORE the exponential variables: coincident monomers would
    # drive the coulomb-type variables to ~1e8 and one f32 inf in the
    # polynomial turns the masked backward pass into 0*inf = NaN forces.
    shift = torch.tensor([5.0, 0.0, 0.0], dtype=pos_a.dtype, device=pos_a.device)
    pos_b = torch.where((~active)[:, None, None], pos_a + shift, pos_b)
    ob, hb1, hb2 = pos_b[:, 0], pos_b[:, 1], pos_b[:, 2]

    xa1, xa2 = monomer_extra_points(oa, ha1, ha2, c['in_plane_gamma'], c['out_of_plane_gamma'])
    xb1, xb2 = monomer_extra_points(ob, hb1, hb2, c['in_plane_gamma'], c['out_of_plane_gamma'])

    def v_exp(k, p1, p2):
        return torch.exp(k * (_D0_INTRA - safe_norm(p1 - p2)))

    def v_exp_inter(k, p1, p2):
        return torch.exp(k * (_D0_INTER - safe_norm(p1 - p2)))

    def v_coul(k, p1, p2):
        r = safe_norm(p1 - p2)
        return torch.exp(k * (_D0_INTER - r)) / r

    # variable layout mirrors MBPolReferenceTwoBodyForce.cpp:170-207
    x = torch.stack([
        v_exp(c['k_HH_intra'], ha1, ha2),
        v_exp(c['k_HH_intra'], hb1, hb2),
        v_exp(c['k_OH_intra'], oa, ha1),
        v_exp(c['k_OH_intra'], oa, ha2),
        v_exp(c['k_OH_intra'], ob, hb1),
        v_exp(c['k_OH_intra'], ob, hb2),
        v_coul(c['k_HH_coul'], ha1, hb1),
        v_coul(c['k_HH_coul'], ha1, hb2),
        v_coul(c['k_HH_coul'], ha2, hb1),
        v_coul(c['k_HH_coul'], ha2, hb2),
        v_coul(c['k_OH_coul'], oa, hb1),
        v_coul(c['k_OH_coul'], oa, hb2),
        v_coul(c['k_OH_coul'], ob, ha1),
        v_coul(c['k_OH_coul'], ob, ha2),
        v_coul(c['k_OO_coul'], oa, ob),
        v_exp_inter(c['k_XH_main'], xa1, hb1),
        v_exp_inter(c['k_XH_main'], xa1, hb2),
        v_exp_inter(c['k_XH_main'], xa2, hb1),
        v_exp_inter(c['k_XH_main'], xa2, hb2),
        v_exp_inter(c['k_XH_main'], xb1, ha1),
        v_exp_inter(c['k_XH_main'], xb1, ha2),
        v_exp_inter(c['k_XH_main'], xb2, ha1),
        v_exp_inter(c['k_XH_main'], xb2, ha2),
        v_exp_inter(c['k_XO_main'], oa, xb1),
        v_exp_inter(c['k_XO_main'], oa, xb2),
        v_exp_inter(c['k_XO_main'], ob, xa1),
        v_exp_inter(c['k_XO_main'], ob, xa2),
        v_exp_inter(c['k_XX_main'], xa1, xb1),
        v_exp_inter(c['k_XX_main'], xa1, xb2),
        v_exp_inter(c['k_XX_main'], xa2, xb1),
        v_exp_inter(c['k_XX_main'], xa2, xb2),
    ], dim=-1)
    return x, roo, active


def two_body_energy_pairs(pos_a, pos_b, valid, pip=None):
    """Two-body energies [P] in kcal/mol for monomer pairs [P, 3, 3]
    (Angstrom, already imaged); `valid` [P] masks padded entries; `pip`:
    optional (impl, basis) of the polynomial evaluator
    (MBPolConfig.pip_impl/pip_basis; None entries = the defaults)."""
    c = _consts()
    x, roo, active = pair_variables(pos_a, pos_b, valid)
    impl, basis = pip or (None, None)
    e_poly = pip_apply('poly2b', x, impl=impl, basis=basis)
    sw = f_switch(roo, c['r2i'], c['r2f'])
    return torch.where(active, sw * e_poly, 0.0)


def all_pairs(n):
    ii, jj = np.triu_indices(n, k=1)
    return np.stack([ii, jj], axis=1)


def _imaged_pairs(system: System, positions, pairs, pair_mask):
    """(pos_a, pos_b [P, 3, 3] Angstrom, imaged; pair_mask [P]) of the
    listed water pairs (default: all i<j)."""
    dev = positions.device
    wpos = water_positions(system, positions) * units.NM_TO_ANGSTROM
    if pairs is None:
        pairs = torch.as_tensor(all_pairs(system.n_waters), device=dev)
    if pair_mask is None:
        pair_mask = torch.ones(len(pairs), dtype=torch.bool, device=dev)
    wflat = wpos.reshape(-1, 9)
    pos_a = gather_rows(wflat, pairs[:, 0], pair_mask).reshape(-1, 3, 3)
    pos_b = gather_rows(wflat, pairs[:, 1], pair_mask).reshape(-1, 3, 3)
    if system.periodic:
        box_a = box_tensor(system.box, positions) * units.NM_TO_ANGSTROM
        pos_a, pos_b = _image_pair(pos_a, pos_b, box_a)
    return pos_a, pos_b, pair_mask


def two_body_variables(system: System, positions, pairs=None, pair_mask=None):
    """The polynomial variables x [P, 31] that `two_body_energy` evaluates
    for these arguments (padded entries hold the substitute geometry)."""
    return pair_variables(*_imaged_pairs(system, positions, pairs, pair_mask))[0]


def two_body_energy(system: System, positions, pairs=None, pair_mask=None, pip=None):
    """Total two-body energy in kJ/mol.

    positions: [natoms, 3] nm. pairs: optional [P, 2] integer tensor of
    water index pairs (default: all i<j); pair_mask: optional [P] bool;
    pip: optional (impl, basis) of the polynomial evaluator.
    """
    e_kcal = two_body_energy_pairs(*_imaged_pairs(system, positions, pairs, pair_mask), pip=pip)
    return torch.sum(e_kcal) * units.KCAL_PER_MOL_TO_KJ_PER_MOL
