"""Simulation loop, velocity-Verlet NVE path
(port of mbpol_openmm_plugin_tpu/md/simulation.py).

Each step is one full potential evaluation. The loop carries the last
k+2 corrected dipole sets of the ASPC closure and feeds the B_j-weighted
predictor into the potential. With
nlist_rebuild_interval='auto' the lists are rebuilt when twice the max O
displacement since the last build exceeds half the skin; the trigger is
read on the host once per step (CUDA graphs are later work).

Thermostats, barostats, RESPA, minimization, checkpoints and per-step
SOR dynamics (the JAX package's scf='keep') are not ported yet (see
ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch import ROADMAP_HINT
from mbpol_openmm_plugin_tpu_torch.md import integrators as I
from mbpol_openmm_plugin_tpu_torch.models import electrostatics as elec
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol
from mbpol_openmm_plugin_tpu_torch.utils import units


def health_flag(diag):
    """Scalar bool tensor: SCF converged (or ASPC healthy) and no padded
    list overflowed."""
    ok = torch.ones((), dtype=torch.bool)
    if 'converged' in diag:
        ok = diag['converged'].cpu() & ok
    for k, v in diag.items():
        if k.endswith('_overflow'):
            ok = ok & ~torch.as_tensor(v).cpu()
    return ok


@dataclasses.dataclass
class SimulationConfig:
    dt: float = 0.0002                   # ps
    temperature: Optional[float] = None  # only None (NVE) is ported
    # 1: lists rebuilt inside every evaluation; 'auto': displacement-
    # triggered rebuild (needs nlist_skin > 0)
    nlist_rebuild_interval: object = 1


class Simulation:
    """Minimal NVE MD loop over an MBPol potential."""

    def __init__(self, potential: MBPol, config: Optional[SimulationConfig] = None):
        self.config = config if config is not None else SimulationConfig()
        cfg = self.config
        if cfg.temperature is not None:
            raise NotImplementedError(f'thermostatted (NVT) dynamics: {ROADMAP_HINT}')
        if cfg.nlist_rebuild_interval not in (1, 'auto'):
            raise NotImplementedError(
                f'nlist_rebuild_interval={cfg.nlist_rebuild_interval!r}: {ROADMAP_HINT}')
        if potential.elec_params is not None and potential.config.scf_method != 'aspc':
            raise NotImplementedError(
                f'dynamics with scf_method={potential.config.scf_method!r} (only the ASPC '
                f'closure of MBPolConfig.for_dynamics() is ported): {ROADMAP_HINT}')
        self.potential = potential
        self.system = potential.system
        self.state: Optional[I.MDState] = None

    def set_positions(self, positions):
        """Start from `positions` (numpy or tensor; moved to the potential's
        device) at rest, with a converged evaluation."""
        positions = self.potential.as_positions(positions)
        e, f, _, _ = self.potential.energy_forces(positions)
        self.state = I.MDState(positions=positions, velocities=torch.zeros_like(positions),
                               forces=f, potential_energy=e, step=0)

    def _auto_rebuild(self, nl_carry, p):
        """Rebuild the lists at p when 2 * max O displacement since the last
        build exceeds skin / 2. nl_carry = (lists, build positions,
        overflow flag); a rebuild's overflow ORs into the flag."""
        nl, pb, ovf = nl_carry
        n = self.system.n_waters
        o_p = p[:4 * n].reshape(n, 4, 3)[:, 0]
        o_b = pb[:4 * n].reshape(n, 4, 3)[:, 0]
        disp = torch.max(torch.linalg.norm(o_p - o_b, dim=-1))
        if float(2.0 * disp) > 0.5 * self.potential.config.nlist_skin:
            (pl, tl), d = self.potential.build_neighbor_lists(p)
            return (pl, tl), p, ovf | d['pair_overflow'] | d['triplet_overflow']
        return nl_carry

    def _chunk(self, state, n_steps):
        """n_steps Verlet steps. Returns (state, per-step PE [n], per-step
        KE [n], overflow)."""
        pot = self.potential
        cfg = self.config
        auto_nl = pot.use_neighbor_lists and cfg.nlist_rebuild_interval == 'auto'
        if auto_nl and not pot.config.nlist_skin > 0:
            raise ValueError("nlist_rebuild_interval='auto' requires nlist_skin > 0")
        aspc = pot.elec_params is not None
        mu = B = None
        if aspc:
            B = torch.as_tensor(elec.aspc_predictor_coefficients(pot.config.aspc_k),
                                dtype=state.positions.dtype, device=state.positions.device)
            # seed the history from a converged evaluation at the chunk's start
            mu = pot._energy_forces_impl(state.positions)[3]['induced_dipoles']
            mu = mu[None].repeat(len(B), 1, 1)

        nl_carry = None
        ovf = torch.zeros((), dtype=torch.bool, device=state.positions.device)
        if auto_nl:
            (pl, tl), d = pot.build_neighbor_lists(state.positions)
            ovf = d['pair_overflow'] | d['triplet_overflow']
            nl_carry = ((pl, tl), state.positions, ovf)

        pes, kes = [], []
        step_ovf = torch.zeros_like(ovf)
        for _ in range(n_steps):
            mu0 = torch.einsum('h,hnd->nd', B, mu) if aspc else None
            out = {}

            def ef(p):
                nonlocal nl_carry, step_ovf
                nl = None
                if nl_carry is not None:
                    nl_carry = self._auto_rebuild(nl_carry, p)
                    nl = nl_carry[0]
                e, f, _, diag = pot._energy_forces_impl(p, mu0, nlists=nl)
                out['mu'] = diag.get('induced_dipoles')
                # lists built inside the evaluation (dispersion pairs, tiles)
                for k, v in diag.items():
                    if k.endswith('_overflow'):
                        step_ovf = step_ovf | v
                return e, f

            state = I.velocity_verlet_step(self.system, ef, state, cfg.dt)
            if aspc:
                mu = torch.cat([out['mu'][None], mu[:-1]], dim=0)
            pes.append(state.potential_energy)
            kes.append(I.kinetic_energy(self.system, state.velocities))
        if nl_carry is not None:
            ovf = nl_carry[2]
        return state, torch.stack(pes), torch.stack(kes), ovf | step_ovf

    def step(self, n_steps, report_interval=None, check_health=True):
        """Advance n_steps. Returns per-report-interval metrics (potential,
        kinetic and total energy in kJ/mol, temperature in K), and
        `step_total_energy` [n_steps + 1], the total energy before the first
        step and after each step (kJ/mol).

        With check_health=True, raises RuntimeError at a report boundary if
        the energy went NaN, a list or tile-pair list overflowed during the
        chunk, or a converged
        diagnostic evaluation of the current positions fails its SCF or
        overflows."""
        report_interval = report_interval or n_steps
        pes, kes, steps = [], [], []
        e_steps = [float(self.state.potential_energy)
                   + float(I.kinetic_energy(self.system, self.state.velocities))]
        remaining = n_steps
        while remaining > 0:
            chunk = min(report_interval, remaining)
            self.state, pe, ke, nl_ovf = self._chunk(self.state, chunk)
            pe_host = pe.cpu().numpy()
            e_steps.extend(pe_host + ke.cpu().numpy())
            if check_health:
                if bool(nl_ovf):
                    raise RuntimeError(
                        f'list or tile-pair overflow during the chunk ending at step '
                        f'{self.state.step}: raise the capacities (tune_capacities)')
                diag = self.potential._energy_forces_impl(self.state.positions)[3]
                nan = np.isnan(pe_host)
                if nan.any() or not bool(health_flag(diag)):
                    at = (self.state.step - chunk + int(np.argmax(nan))
                          if nan.any() else self.state.step)
                    raise RuntimeError(
                        'simulation health check failed at step %d: %s' %
                        (at, {k: v for k, v in diag.items()
                              if k in ('converged', 'iterations', 'epsilon')
                              or k.endswith('_overflow')}))
            pes.append(float(pe_host[-1]))
            kes.append(float(I.kinetic_energy(self.system, self.state.velocities)))
            steps.append(self.state.step)
            remaining -= chunk
        ndof = 3 * int(np.sum(np.asarray(self.system.masses) > 0))
        pes = np.asarray(pes)
        kes = np.asarray(kes)
        return dict(step=np.asarray(steps), potential_energy=pes, kinetic_energy=kes,
                    total_energy=pes + kes, step_total_energy=np.asarray(e_steps),
                    temperature=2.0 * kes / (ndof * units.BOLTZMANN_KJ_MOL_K))
