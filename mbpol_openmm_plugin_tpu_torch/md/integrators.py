"""Integrators (velocity Verlet, BAOAB Langevin and their r-RESPA
multiple-time-step forms), thermostats and the Monte Carlo barostat
(port of mbpol_openmm_plugin_tpu/md/integrators.py).

Units: nm, ps, amu, kJ/mol; velocities nm/ps. M sites carry zero mass:
the update skips them (their positions are recomputed by the potential and
their force rows are zero after redistribution).

Every stochastic function takes its random draws as arguments (standard
normals, uniforms in [0, 1)): `Simulation` draws them from one
torch.Generator on the state's device, for every atom with fixed shapes,
and the tests feed the draws of the JAX package's key splits. The box is a
host float64 triple: a barostat move decides on the host (one read of the
two energies) and the kernels take the box by value.

The RESPA steps take the force of each rung at the state's positions and
return it at the new ones, so that a caller carries them from step to step
(and across its groups): each step then evaluates the slow rung once. A
rung whose evaluation has state (the ASPC dipole history) must be carried,
never re-evaluated at the step's start.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch.system import System
from mbpol_openmm_plugin_tpu_torch.utils import tracing, units
from mbpol_openmm_plugin_tpu_torch.utils.consts import device_const

# 1 bar in kJ/mol/nm^3
BAR_KJ_MOL_NM3 = 0.0602214076


@dataclasses.dataclass
class MDState:
    positions: torch.Tensor        # [natoms, 3] nm
    velocities: torch.Tensor       # [natoms, 3] nm/ps
    forces: torch.Tensor           # [natoms, 3] kJ/mol/nm at `positions`
    potential_energy: torch.Tensor
    box: Optional[np.ndarray] = None   # [3] nm, float64 on the host (None: not periodic)
    step: int = 0


def _masses(system: System, like):
    return device_const(np.asarray(system.masses), dtype=like.dtype, device=like.device)[:, None]


def inv_masses(system: System, like):
    m = np.asarray(system.masses)
    inv = np.where(m > 0, 1.0 / np.where(m > 0, m, 1.0), 0.0)
    return device_const(inv, dtype=like.dtype, device=like.device)[:, None]


def kinetic_energy(system: System, velocities):
    m = device_const(np.asarray(system.masses), dtype=velocities.dtype,
                     device=velocities.device)
    return 0.5 * torch.sum(m[:, None] * velocities * velocities)


def temperature(system: System, velocities):
    """Instantaneous temperature (3 dof per real atom; M sites excluded)."""
    ndof = 3 * int(np.sum(np.asarray(system.masses) > 0))
    return 2.0 * kinetic_energy(system, velocities) / (ndof * units.BOLTZMANN_KJ_MOL_K)


def maxwell_boltzmann_velocities(system: System, temperature_k, normals):
    """Velocities at temperature_k from standard normals [natoms, 3]
    (sigma = sqrt(kT / m); zero for the massless M sites)."""
    m = np.asarray(system.masses)
    sigma = np.sqrt(units.BOLTZMANN_KJ_MOL_K * temperature_k / np.where(m > 0, m, 1.0))
    sigma = np.where(m > 0, sigma, 0.0)
    return normals * device_const(sigma, dtype=normals.dtype, device=normals.device)[:, None]


def velocity_verlet_step(system: System, energy_forces_fn, state: MDState, dt):
    """One velocity-Verlet step. energy_forces_fn: positions -> (E, F)."""
    inv_m = inv_masses(system, state.positions)
    v_half = state.velocities + 0.5 * dt * state.forces * inv_m
    pos = state.positions + dt * v_half
    energy, forces = energy_forces_fn(pos)
    v_new = v_half + 0.5 * dt * forces * inv_m
    return dataclasses.replace(state, positions=pos, velocities=v_new, forces=forces,
                               potential_energy=energy, step=state.step + 1)


def _inner_verlet(ef_fast, pos, v, f_fast, inv_m, dti):
    """One velocity-Verlet step of the fast rung: (pos, v, f_fast, e_fast)."""
    v = v + 0.5 * dti * f_fast * inv_m
    pos = pos + dti * v
    e_fast, f_fast = ef_fast(pos)
    return pos, v + 0.5 * dti * f_fast * inv_m, f_fast, e_fast


def respa_velocity_verlet_step(system: System, ef_fast, ef_slow, state: MDState, f_slow, dt,
                               n_inner, f_fast=None):
    """One two-level r-RESPA step (Tuckerman-Berne-Martyna): half kicks of
    the slow forces at the outer step dt around n_inner velocity-Verlet
    steps of the fast forces at dt / n_inner.

    f_slow (and f_fast, when given; else it is evaluated at the state's
    positions) are the rungs' forces at state.positions. Returns (state',
    f_slow', f_fast') with state'.forces their sum and potential_energy the
    fast + slow energy at the new positions."""
    inv_m = inv_masses(system, state.positions)
    dti = dt / n_inner
    v = state.velocities + 0.5 * dt * f_slow * inv_m
    if f_fast is None:
        f_fast = ef_fast(state.positions)[1]
    pos = state.positions
    for _ in range(int(n_inner)):
        pos, v, f_fast, e_fast = _inner_verlet(ef_fast, pos, v, f_fast, inv_m, dti)
    e_slow, f_slow = ef_slow(pos)
    v = v + 0.5 * dt * f_slow * inv_m
    state = dataclasses.replace(state, positions=pos, velocities=v, forces=f_slow + f_fast,
                                potential_energy=e_slow + e_fast, step=state.step + 1)
    return state, f_slow, f_fast


def respa3_velocity_verlet_step(system: System, ef_fast, ef_mid, ef_slow, state: MDState,
                                f_mid, f_slow, dt, n_mid, n_inner, f_fast=None):
    """One three-level r-RESPA step: half kicks of the slow forces at dt
    around n_mid middle steps at dt / n_mid, each half kicks of the mid
    forces around n_inner velocity-Verlet steps of the fast forces at
    dt / (n_mid n_inner). f_mid, f_slow (and f_fast, when given) are the
    rungs' forces at state.positions. Returns (state', f_mid', f_slow',
    f_fast') with state'.forces their sum and potential_energy the sum of
    the three energies at the new positions."""
    inv_m = inv_masses(system, state.positions)
    dtm = dt / n_mid
    dti = dtm / n_inner
    v = state.velocities + 0.5 * dt * f_slow * inv_m
    if f_fast is None:
        f_fast = ef_fast(state.positions)[1]
    pos = state.positions
    for _ in range(int(n_mid)):
        v = v + 0.5 * dtm * f_mid * inv_m
        for _ in range(int(n_inner)):
            pos, v, f_fast, e_fast = _inner_verlet(ef_fast, pos, v, f_fast, inv_m, dti)
        e_mid, f_mid = ef_mid(pos)
        v = v + 0.5 * dtm * f_mid * inv_m
    e_slow, f_slow = ef_slow(pos)
    v = v + 0.5 * dt * f_slow * inv_m
    state = dataclasses.replace(state, positions=pos, velocities=v,
                                forces=f_fast + f_mid + f_slow,
                                potential_energy=e_fast + e_mid + e_slow, step=state.step + 1)
    return state, f_mid, f_slow, f_fast


def respa_langevin_step(system: System, ef_fast, ef_slow, state: MDState, f_slow, dt, n_inner,
                        temperature_k, friction, noises, f_fast=None):
    """BAOAB-RESPA Langevin step: half kicks of the slow forces around
    n_inner BAOAB steps of the fast forces, the O step in each with the
    inner step's friction factor (n_inner = 1 is BAOAB with the force
    split). noises: standard normals [n_inner, natoms, 3], one set per
    inner O step. Returns (state', f_slow', f_fast') as
    `respa_velocity_verlet_step`."""
    inv_m = inv_masses(system, state.positions)
    m = _masses(system, state.positions)
    kT = units.BOLTZMANN_KJ_MOL_K * temperature_k
    dti = dt / n_inner
    c1 = math.exp(-friction * dti)
    c2 = math.sqrt((1.0 - c1 * c1) * kT)

    v = state.velocities + 0.5 * dt * f_slow * inv_m
    if f_fast is None:
        f_fast = ef_fast(state.positions)[1]
    pos = state.positions
    for k in range(int(n_inner)):
        v = v + 0.5 * dti * f_fast * inv_m
        pos = pos + 0.5 * dti * v
        v = c1 * v + torch.where(m > 0, c2 * torch.sqrt(inv_m) * noises[k], 0.0)
        pos = pos + 0.5 * dti * v
        e_fast, f_fast = ef_fast(pos)
        v = v + 0.5 * dti * f_fast * inv_m
    e_slow, f_slow = ef_slow(pos)
    v = v + 0.5 * dt * f_slow * inv_m
    state = dataclasses.replace(state, positions=pos, velocities=v, forces=f_slow + f_fast,
                                potential_energy=e_slow + e_fast, step=state.step + 1)
    return state, f_slow, f_fast


def remove_cm_motion(system: System, velocities):
    """OpenMM CMMotionRemover: subtract the mass-weighted centre-of-mass
    velocity from every massive particle (the M sites keep their zero
    velocities)."""
    m = _masses(system, velocities)
    v_cm = torch.sum(m * velocities, dim=0) / torch.sum(m)
    return torch.where(m > 0, velocities - v_cm, velocities)


def andersen_thermostat(system: System, state: MDState, dt, temperature_k,
                        collision_frequency, uniforms, normals):
    """Andersen thermostat: each real atom's velocity is redrawn from the
    Maxwell-Boltzmann distribution with probability 1 - exp(-freq dt).
    uniforms [natoms] decide the collisions, normals [natoms, 3] give the
    new velocities."""
    m = np.asarray(system.masses)
    p_collide = 1.0 - np.exp(-collision_frequency * dt)
    real = device_const(m > 0, device=uniforms.device)
    hit = (uniforms < p_collide) & real
    v_new = maxwell_boltzmann_velocities(system, temperature_k, normals)
    return dataclasses.replace(state, velocities=torch.where(hit[:, None], v_new,
                                                             state.velocities))


def langevin_step(system: System, energy_forces_fn, state: MDState, dt, temperature_k,
                  friction, noise):
    """BAOAB Langevin step (Leimkuhler-Matthews); noise: standard normals
    [natoms, 3] of the O step."""
    inv_m = inv_masses(system, state.positions)
    m = _masses(system, state.positions)
    kT = units.BOLTZMANN_KJ_MOL_K * temperature_k
    c1 = math.exp(-friction * dt)
    c2 = math.sqrt((1.0 - c1 * c1) * kT)

    v = state.velocities + 0.5 * dt * state.forces * inv_m
    pos = state.positions + 0.5 * dt * v
    v = c1 * v + torch.where(m > 0, c2 * torch.sqrt(inv_m) * noise, 0.0)
    pos = pos + 0.5 * dt * v
    energy, forces = energy_forces_fn(pos)
    v = v + 0.5 * dt * forces * inv_m
    return dataclasses.replace(state, positions=pos, velocities=v, forces=forces,
                               potential_energy=energy, step=state.step + 1)


def molecule_members(system: System):
    """[n_molecules, k] the atom indices of each molecule (system.mol_index)
    in atom order, padded with n_atoms: k = 4 for waters, a Cl- ion has one
    member. On the water-only layout it is arange(n_atoms) as [n_waters, 4]."""
    mol = np.asarray(system.mol_index)
    counts = np.bincount(mol)
    order = np.argsort(mol, kind='stable')
    rank = np.arange(len(mol)) - (np.cumsum(counts) - counts)[mol[order]]
    members = np.full((len(counts), int(counts.max())), len(mol), np.int64)
    members[mol[order], rank] = order
    return members


def molecule_centroid_shift(system: System, positions, length_scale):
    """[natoms, 3]: each atom's share of its molecule's centroid move when
    the centroids scale by length_scale. Molecules are those of
    system.mol_index, ions included; each centroid is the mass-weighted sum
    over its members in atom order (a fixed order: on the water-only layout
    the bits of a sum over each water's four sites), padding members being a
    zero row of zero mass."""
    members = device_const(molecule_members(system), device=positions.device)
    m = device_const(np.append(np.asarray(system.masses), 0.0), dtype=positions.dtype,
                     device=positions.device)[members][..., None]
    p = torch.cat([positions, positions.new_zeros(1, 3)])[members]
    centroid = torch.sum(m * p, dim=1) / torch.sum(m, dim=1)
    mol = device_const(np.asarray(system.mol_index, np.int64), device=positions.device)
    return (centroid * (length_scale - 1.0))[mol]


def monte_carlo_barostat_move(system: System, energy_fn, state: MDState, temperature_k,
                              pressure_bar, scale, uniforms):
    """One MC volume move (OpenMM MonteCarloBarostat): the molecule centroids
    (waters and ions) scale isotropically with the box, Metropolis
    acceptance on dU + P dV - N kT ln(V'/V), N the number of molecules.
    Returns (state, accepted: bool).

    scale: the move size (nm^3); uniforms: two draws in [0, 1), the volume
    change and the acceptance. energy_fn(positions, box) -> (energy,
    forces) is a converged evaluation; both sides of the weight come from
    it (the trajectory's ASPC energy and a converged one differ by an
    offset that, mixed into the weight, rejected every move in the JAX
    package's run). The accepted state takes the trial's energy and forces;
    a rejected one keeps its forces and takes the converged energy. The
    decision reads the two energies on the host once."""
    u_dv, u_acc = (float(u) for u in uniforms.tolist())
    tracing.count('host_reads')
    kT = units.BOLTZMANN_KJ_MOL_K * temperature_k
    box = np.asarray(state.box, np.float64)
    vol = float(np.prod(box))
    dv = (u_dv * 2.0 - 1.0) * scale
    new_vol = vol + dv
    length_scale = (new_vol / vol) ** (1.0 / 3.0)
    pos_new = state.positions + molecule_centroid_shift(system, state.positions, length_scale)
    box_new = box * length_scale

    e_new, f_new = energy_fn(pos_new, box_new)
    e_old, _ = energy_fn(state.positions, box)
    e_new_h, e_old_h = torch.stack([e_new, e_old]).double().tolist()
    tracing.count('host_reads')
    w = e_new_h - e_old_h + pressure_bar * BAR_KJ_MOL_NM3 * dv \
        - (int(np.max(system.mol_index)) + 1) * kT * math.log(new_vol / vol)
    accept = w <= 0 or u_acc < math.exp(-w / kT)
    if accept:
        state = dataclasses.replace(state, positions=pos_new, box=box_new, forces=f_new,
                                    potential_energy=e_new)
    else:
        state = dataclasses.replace(state, potential_energy=e_old)
    return state, accept


def barostat_scale_init(box):
    """Initial adaptive move state (scale nm^3, attempted, accepted): the
    scale starts at 1% of the volume (OpenMM MonteCarloBarostatImpl)."""
    return (0.01 * float(np.prod(np.asarray(box, np.float64))), 0, 0)


def barostat_scale_update(baro, accept, volume):
    """OpenMM MonteCarloBarostatImpl's adaptation: once at least 10 moves
    were attempted, shrink the scale /1.1 when under a quarter were
    accepted, grow it x1.1 (at most 0.3 V) when over three quarters were;
    the counters restart only when the scale changes."""
    scale, att, acc = baro
    att += 1
    acc += int(bool(accept))
    low = acc < 0.25 * att
    high = acc > 0.75 * att
    if att >= 10 and (low or high):
        scale = scale / 1.1 if low else min(scale * 1.1, 0.3 * volume)
        att = acc = 0
    return (scale, att, acc)


def monte_carlo_barostat_move_adaptive(system: System, energy_fn, state: MDState,
                                       temperature_k, pressure_bar, baro, uniforms):
    """`monte_carlo_barostat_move` with OpenMM's adaptive move size; baro
    from `barostat_scale_init`. Returns (state, baro', accepted)."""
    state, accept = monte_carlo_barostat_move(system, energy_fn, state, temperature_k,
                                              pressure_bar, baro[0], uniforms)
    return state, barostat_scale_update(baro, accept, float(np.prod(state.box))), accept
