"""Splitting an MB-pol potential into its intra- and intermolecular parts
(port of `mbpol_intra_inter_split` from mbpol_openmm_plugin_tpu/md/rpmd.py;
the ring-polymer integrators of that module are not ported yet, see
ROADMAP.md).

r-RESPA runs the fast one-body term on the inner rung and the rest on the
outer ones (md/simulation.py); ring-polymer contraction will evaluate the
same two parts on different bead sets.
"""
from __future__ import annotations

import dataclasses

import torch

from mbpol_openmm_plugin_tpu_torch.models.one_body import one_body_energy
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, inherit_capacities
from mbpol_openmm_plugin_tpu_torch.system import make_molecules_whole, water_positions


def term_subset(potential: MBPol, terms):
    """An MBPol over the same system, device and configuration with only
    `terms`, on the parent's tuned capacities (inherit_capacities)."""
    return inherit_capacities(potential, MBPol(
        potential.system, dataclasses.replace(potential.config, terms=tuple(terms)),
        device=potential.device))


def mbpol_intra_inter_split(potential: MBPol):
    """(ef_intra, pot_inter): ef_intra(positions, box=None) -> (E, F) is the
    one-body Partridge-Schwenke term on whole molecules (zero when the
    parent has no one-body term); pot_inter is an MBPol over the parent's
    other terms with its capacities (the parent itself when it has no
    one-body term)."""
    sys_ = potential.system
    has_one_body = 'one_body' in potential.config.terms
    pot_inter = (term_subset(potential, [t for t in potential.config.terms if t != 'one_body'])
                 if has_one_body else potential)

    def ef_intra(p, box=None):
        if not has_one_body:
            return torch.zeros((), dtype=p.dtype, device=p.device), torch.zeros_like(p)
        with torch.enable_grad():
            q = p.detach().requires_grad_(True)
            # hydrogens imaged next to their O as in the full evaluation
            e = torch.sum(one_body_energy(water_positions(
                sys_, make_molecules_whole(sys_, q, box))))
            g, = torch.autograd.grad(e, q)
        return e.detach(), -g

    return ef_intra, pot_inter
