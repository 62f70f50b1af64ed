"""Instantaneous virial pressure (port of mbpol_openmm_plugin_tpu/md/pressure.py).

P = (2 K_com - dU/dlambda) / (3 V), where lambda scales the molecular
centroids (mass-weighted; rigid intramolecular geometry) and the box
isotropically, the Monte Carlo barostat's move, and K_com is the molecular
centre-of-mass kinetic energy (or its equipartition value 3/2 N_mol kT).

dU/dlambda is taken by autograd through a tensor lambda, as the JAX
package takes it by forward-mode autodiff through the box: the positions
q + (lambda - 1) c_mol and the box lambda L enter the closed-form terms
and `models/pme.pme_variational_energy`, the electrostatic energy at the
induced dipoles of a tightly converged SOR evaluation at lambda = 1, held
fixed. That energy is stationary in the dipoles there, so the derivative
is the converged energy's total derivative, which JAX reaches by carrying
the tangent through its SCF loop. A pair at a sharp cutoff (the PME direct
space, the truncated dispersion) keeps the side it is on, as under JAX's
jvp: no jump is differenced. As JAX's traced box routes its electrostatics
onto the XLA path, this derivative runs the plain formulas on either
device, with the lists of the lambda = 1 evaluation; no kernel is on it.
SCF target: PRESSURE_EPSILON.
"""
from __future__ import annotations

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch.models import pme as pme_mod
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, with_scf_method
from mbpol_openmm_plugin_tpu_torch.system import (box_tensor, compute_virtual_sites,
                                                  index_tensor, make_molecules_whole)
from mbpol_openmm_plugin_tpu_torch.utils import units
from mbpol_openmm_plugin_tpu_torch.utils.consts import device_const

# 1 bar in kJ/mol/nm^3
BAR_IN_KJ_MOL_NM3 = 0.0602214076
# the SCF target of the lambda = 1 evaluation (also its float32 floor)
PRESSURE_EPSILON = {torch.float64: 1e-10, torch.float32: 1e-6}


def _molecular_coms(system, arr):
    """Mass-weighted molecule centroids of a per-atom [..., natoms, 3] array
    (the massless M sites drop out) and the molecule masses, by a
    mass-weighted one-hot product (a fixed summation order)."""
    mol = np.asarray(system.mol_index)
    nmol = int(mol.max()) + 1
    w = (mol[None, :] == np.arange(nmol)[:, None]) * np.asarray(system.masses)[None, :]
    w = device_const(w, dtype=arr.dtype, device=arr.device)
    mol_mass = torch.sum(w, dim=1)
    return torch.matmul(w, arr) / mol_mass[:, None], mol_mass


def _periodic_box(system, box, what):
    b = system.box if box is None else box
    if b is None or not np.all(np.asarray(b) > 0):
        raise ValueError(f'{what} needs a periodic system')
    return np.asarray(b, np.float64)


def _bead_du(pot: MBPol, qb, shift, box):
    """dU/dlambda of one bead qb [natoms, 3] moved by (lambda - 1) shift in
    the box lambda * box, at lambda = 1 (a 0-d tensor)."""
    system = pot.system
    _, _, _, diag = pot._energy_forces_impl(qb, box=box)
    over = [k for k, v in diag.items() if k.endswith('_overflow') and bool(v)]
    if over:
        raise RuntimeError(f'virial pressure: {over} at the evaluation; raise the capacities')
    nlists, disp_pairs, _ = pot._lists(make_molecules_whole(system, qb, box), box)
    lam = torch.ones((), dtype=qb.dtype, device=qb.device, requires_grad=True)
    with torch.enable_grad():
        b = lam * box_tensor(box, qb)
        p = make_molecules_whole(system, qb + (lam - 1.0) * shift, b)
        u = sum(pot._smooth_terms(p, nlists, disp_pairs, b).values(), lam * 0.0)
        if pot.elec_params is not None:
            u = u + pme_mod.pme_variational_energy(
                pot.elec_params, pot.pme, compute_virtual_sites(system, p),
                diag['induced_dipoles'], b, tables=pot._site_tables())
        du, = torch.autograd.grad(u, lam)
    return du


def du_dlambda(potential: MBPol, positions, box):
    """d mean_b U(q_b + (lambda - 1) c_mol, lambda box) / d lambda at
    lambda = 1 (c_mol: the molecular centroids of the bead mean; one bead
    for the classical pressure). positions: [n_beads, natoms, 3]; box:
    three floats. Returns a float (kJ/mol)."""
    q = potential.as_positions(positions)
    eps = PRESSURE_EPSILON[q.dtype]
    method = 'sor' if potential.config.scf_method == 'aspc' else potential.config.scf_method
    pot = with_scf_method(potential, method, target_epsilon=eps, scf_eps_floor=eps,
                          max_iterations=max(int(potential.config.max_iterations), 500))
    if pot.elec_params is not None and pot.pme is None:
        raise ValueError('the virial pressure needs PME electrostatics')
    system = potential.system
    centroid, _ = _molecular_coms(system, torch.mean(q, dim=0))
    shift = centroid[index_tensor(system.mol_index, q)]
    du = torch.stack([_bead_du(pot, qb, shift, box) for qb in q])
    return float(torch.mean(du.double()))


def virial_pressure(potential: MBPol, positions, velocities=None, temperature_k=None, box=None):
    """Instantaneous molecular virial pressure, in bar:
    P = (2 K_com - dU/dlambda) / (3 V). Give `velocities` ([natoms, 3]
    nm/ps) for the instantaneous kinetic part or `temperature_k` for its
    equipartition average 2 <K_com> = 3 N_mol kT. Periodic systems only;
    box: the evaluation's box (default the system's)."""
    system = potential.system
    b = _periodic_box(system, box, 'virial_pressure')
    if velocities is None and temperature_k is None:
        raise ValueError('provide velocities or temperature_k')
    q = potential.as_positions(positions)
    du = du_dlambda(potential, q[None], b)
    nmol = int(np.asarray(system.mol_index).max()) + 1
    if velocities is not None:
        vcom, mol_mass = _molecular_coms(system, potential.as_positions(velocities))
        twice_k = float(torch.sum(mol_mass[:, None] * vcom * vcom))
    else:
        twice_k = 3.0 * nmol * units.BOLTZMANN_KJ_MOL_K * temperature_k
    return (twice_k - du) / (3.0 * float(np.prod(b))) / BAR_IN_KJ_MOL_NM3


def rpmd_virial_pressure(potential: MBPol, positions, temperature_k, box=None):
    """Instantaneous NPT-PIMD pressure, in bar (the ring-polymer form of
    `virial_pressure`, the ensemble of rpmd.rpmd_barostat_move): each
    molecule's beads shift rigidly with its ring-polymer centroid, so
    P = (3 N_mol kT - d Ubar/dlambda) / (3 V) with Ubar the bead-mean
    energy; the springs are invariant under the move. positions:
    [n_beads, natoms, 3]. At one bead it equals virial_pressure with
    temperature_k."""
    system = potential.system
    b = _periodic_box(system, box, 'rpmd_virial_pressure')
    du = du_dlambda(potential, positions, b)
    nmol = int(np.asarray(system.mol_index).max()) + 1
    twice_k = 3.0 * nmol * units.BOLTZMANN_KJ_MOL_K * temperature_k
    return (twice_k - du) / (3.0 * float(np.prod(b))) / BAR_IN_KJ_MOL_NM3
