"""Velocity Verlet and state bookkeeping (port of the NVE part of
mbpol_openmm_plugin_tpu/md/integrators.py).

Units: nm, ps, amu, kJ/mol; velocities nm/ps. M sites carry zero mass:
the update skips them (their positions are recomputed by the potential and
their force rows are zero after redistribution). Langevin, Andersen,
RESPA and the barostats are not ported yet (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch.system import System
from mbpol_openmm_plugin_tpu_torch.utils import units


@dataclasses.dataclass
class MDState:
    positions: torch.Tensor        # [natoms, 3] nm
    velocities: torch.Tensor       # [natoms, 3] nm/ps
    forces: torch.Tensor           # [natoms, 3] kJ/mol/nm at `positions`
    potential_energy: torch.Tensor
    step: int = 0


def inv_masses(system: System, like):
    m = np.asarray(system.masses)
    inv = np.where(m > 0, 1.0 / np.where(m > 0, m, 1.0), 0.0)
    return torch.as_tensor(inv, dtype=like.dtype, device=like.device)[:, None]


def kinetic_energy(system: System, velocities):
    m = torch.as_tensor(np.asarray(system.masses), dtype=velocities.dtype,
                        device=velocities.device)
    return 0.5 * torch.sum(m[:, None] * velocities * velocities)


def temperature(system: System, velocities):
    """Instantaneous temperature (3 dof per real atom; M sites excluded)."""
    ndof = 3 * int(np.sum(np.asarray(system.masses) > 0))
    return 2.0 * kinetic_energy(system, velocities) / (ndof * units.BOLTZMANN_KJ_MOL_K)


def velocity_verlet_step(system: System, energy_forces_fn, state: MDState, dt):
    """One velocity-Verlet step. energy_forces_fn: positions -> (E, F)."""
    inv_m = inv_masses(system, state.positions)
    v_half = state.velocities + 0.5 * dt * state.forces * inv_m
    pos = state.positions + dt * v_half
    energy, forces = energy_forces_fn(pos)
    v_new = v_half + 0.5 * dt * forces * inv_m
    return dataclasses.replace(state, positions=pos, velocities=v_new, forces=forces,
                               potential_energy=energy, step=state.step + 1)
