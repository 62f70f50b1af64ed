"""Flat-bottom spherical restraint for clusters
(port of mbpol_openmm_plugin_tpu/models/restraint.py).

    E = k/2 * sum_i max(0, |r_i - c| - R)^2      over the oxygen sites,

with c the instantaneous oxygen centroid. The centroid is part of the
differentiated expression, so the restraint forces sum to zero and the term
is a smooth (C^1) conservative potential. Enabled by
`MBPolConfig(restraint_radius=..., restraint_k=...)` on non-periodic
systems; `MBPol._smooth_terms` evaluates it, so its forces come from the
same autograd pass as the other smooth terms.
"""
import torch


def flat_bottom_energy(o_pos, radius, k):
    """Restraint energy (kJ/mol) of oxygen positions o_pos [n, 3] (nm) about
    their centroid: zero inside `radius` (nm), harmonic with spring
    constant `k` (kJ/mol/nm^2) outside. The 1e-12 under the square root
    keeps the gradient finite for a site exactly at the centroid."""
    dr = o_pos - torch.mean(o_pos, dim=0)
    d = torch.sqrt(torch.sum(dr * dr, dim=-1) + 1e-12)
    over = torch.clamp_min(d - radius, 0.0)
    return 0.5 * k * torch.sum(over * over)
