"""The full MB-pol potential for the PME dense slice
(port of mbpol_openmm_plugin_tpu/models/potential.py).

Positions of the real atoms in, per-term energies and total forces out.
The smooth terms (one-body, 2B/3B PIPs, dispersion) get their forces from
torch.autograd through the M-site placement; the electrostatic forces are
explicit and the M-site share is redistributed with the average3 weights.

Accepted here: PME, electrostatics_mode 'auto'/'dense', dispersion_mode
'auto'/'dense', scf_method 'sor'/'aspc', analytic list capacities. Every
other option raises NotImplementedError (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch import ROADMAP_HINT, _data
from mbpol_openmm_plugin_tpu_torch.models import electrostatics as elec
from mbpol_openmm_plugin_tpu_torch.models import pme as pme_mod
from mbpol_openmm_plugin_tpu_torch.models.dispersion import dispersion_energy
from mbpol_openmm_plugin_tpu_torch.models.one_body import one_body_energy
from mbpol_openmm_plugin_tpu_torch.models.three_body import three_body_energy
from mbpol_openmm_plugin_tpu_torch.models.two_body import two_body_energy
from mbpol_openmm_plugin_tpu_torch.ops import neighbors
from mbpol_openmm_plugin_tpu_torch.system import (System, _contiguous_waters,
                                                  compute_virtual_sites,
                                                  make_molecules_whole,
                                                  water_positions)

# Dense direct space up to this many waters: the [N,N] s3/s5/delta tensors
# are the only O(N^2) memory. Sized so that water256 resolves to 'dense';
# re-deriving it for 80 GB of device memory is later work.
DENSE_LIMIT = 512


@dataclasses.dataclass(frozen=True)
class MBPolConfig:
    """Static evaluation options: the JAX package's MBPolConfig fields that
    the slice uses, with the same defaults (list compaction, reference
    triplet semantics, PIP impl/basis and the cluster restraint are not
    ported)."""
    nonbonded_method: str = 'NoCutoff'
    cutoff: float = 0.9
    cutoff_2b: float = 0.65
    cutoff_3b: float = 0.45
    use_neighbor_lists: Optional[bool] = None   # default: n_waters > 24
    neighbor_capacity_factor: float = 1.5
    nlist_skin: float = 0.0
    include_charge_redistribution: bool = True
    ewald_error_tolerance: float = 1e-4
    ewald_alpha: Optional[float] = None
    pme_grid: Optional[tuple] = None
    target_epsilon: float = 1e-7
    max_iterations: int = 200
    scf_method: str = 'sor'
    aspc_k: int = 3
    aspc_n_corr: int = 1
    thole: Optional[tuple] = None
    electrostatics_mode: str = 'auto'
    dispersion_mode: str = 'auto'
    dispersion_switch_width: float = 0.0
    scf_eps_floor: Optional[float] = None
    terms: tuple = ('electrostatics', 'one_body', 'two_body', 'three_body', 'dispersion')

    @classmethod
    def for_dynamics(cls, **overrides):
        """The production MD operating point: PME with a 0.9 nm cutoff, the
        ASPC closure (k=3, one SOR-damped corrector), target_epsilon 1e-3,
        a 0.02 nm list skin and a 0.1 nm C2 dispersion switch."""
        base = dict(nonbonded_method='PME', cutoff=0.9,
                    target_epsilon=1e-3, max_iterations=200,
                    scf_method='aspc', aspc_k=3, aspc_n_corr=1,
                    nlist_skin=0.02, dispersion_switch_width=0.1)
        base.update(overrides)
        return cls(**base)


def _not_ported(what):
    return NotImplementedError(f'{what}: {ROADMAP_HINT}')


def _check_config(system: System, config: MBPolConfig):
    if config.nonbonded_method not in ('NoCutoff', 'PME'):
        raise ValueError(config.nonbonded_method)
    if config.nonbonded_method == 'PME' and not system.periodic:
        raise ValueError('PME requires a periodic box')
    if config.nonbonded_method == 'NoCutoff' and 'electrostatics' in config.terms:
        raise _not_ported('cluster (NoCutoff) electrostatics')
    if 'electrostatics' in config.terms and system.n_ions:
        raise ValueError('MB-pol electrostatics supports water-only systems')
    unsupported = [
        (config.electrostatics_mode not in ('auto', 'dense'),
         f'electrostatics_mode={config.electrostatics_mode!r}'),
        (config.dispersion_mode not in ('auto', 'dense'),
         f'dispersion_mode={config.dispersion_mode!r}'),
        (config.scf_method not in ('sor', 'aspc'), f'scf_method={config.scf_method!r}'),
        (system.n_ions > 0 or not _contiguous_waters(system),
         'ions and non-standard site layouts'),
    ]
    for bad, what in unsupported:
        if bad:
            raise _not_ported(what)


class MBPol:
    """MB-pol potential for a fixed topology.

        pot = MBPol(system, MBPolConfig(nonbonded_method='PME'))
        energy, forces, parts, diag = pot.energy_forces(positions)

    `positions` are [natoms, 3] nm including M-site slots (overwritten by
    the virtual-site placement).
    """

    def __init__(self, system: System, config: MBPolConfig = MBPolConfig()):
        _check_config(system, config)
        self.system = system
        self.config = config
        self.elec_params = None
        self.pme = None
        if 'electrostatics' in config.terms:
            self.elec_params = elec.ElecParams.for_system(
                system,
                include_charge_redistribution=config.include_charge_redistribution,
                target_epsilon=config.target_epsilon,
                max_iterations=config.max_iterations,
                scf_method=config.scf_method,
                aspc_k=config.aspc_k,
                aspc_n_corr=config.aspc_n_corr,
                scf_eps_floor=config.scf_eps_floor)
            if config.thole is not None:
                self.elec_params = dataclasses.replace(
                    self.elec_params, thole=np.asarray(config.thole))
            self.pme = pme_mod.PmeSetup.from_config(system, config)
            if system.n_waters > DENSE_LIMIT:
                raise _not_ported(f'{system.n_waters} waters: the block/sparse '
                                  f'electrostatics above {DENSE_LIMIT} waters')
        use_nl = config.use_neighbor_lists
        self.use_neighbor_lists = system.n_waters > 24 if use_nl is None else use_nl
        # triplet-build shape parameters (None = analytic bound)
        self.nlist_k_max = None
        self.nlist_kt = None
        if self.use_neighbor_lists:
            box, f = system.box, config.neighbor_capacity_factor
            self.pair_cap = neighbors.pair_capacity(
                system.n_waters, box, config.cutoff_2b + config.nlist_skin, factor=f)
            self.trip_cap = neighbors.triplet_capacity(
                system.n_waters, box, config.cutoff_3b + config.nlist_skin, factor=f)

    def _neighbor_lists(self, positions):
        """Padded pair/triplet lists from the O positions, cutoffs + skin.
        Returns ((pairs, pmask), (trips, tmask), diag with overflow flags)."""
        sys_ = self.system
        o_pos = positions[:4 * sys_.n_waters].reshape(sys_.n_waters, 4, 3)[:, 0]
        skin = self.config.nlist_skin
        pairs, pmask, n_p = neighbors.pair_list(o_pos, sys_.box,
                                                self.config.cutoff_2b + skin, self.pair_cap)
        k_max = self.nlist_k_max
        if k_max is None:
            k_max = neighbors.max_neighbors(sys_.n_waters, sys_.box,
                                            self.config.cutoff_3b + skin)
        trips, tmask, n_t = neighbors.triplet_list(
            o_pos, sys_.box, self.config.cutoff_3b + skin, self.trip_cap,
            k_max=k_max, kt=self.nlist_kt)
        diag = dict(n_pairs=n_p, n_triplets=n_t,
                    pair_overflow=n_p > self.pair_cap,
                    triplet_overflow=n_t > self.trip_cap)
        return (pairs, pmask), (trips, tmask), diag

    def build_neighbor_lists(self, positions):
        """Lists for reuse across MD steps (pair with nlist_skin > 0), built
        on the positions' device. Returns ((pl, tl), diag)."""
        pl, tl, diag = self._neighbor_lists(make_molecules_whole(self.system, positions))
        return (pl, tl), diag

    def _smooth_terms(self, positions, nlists=None):
        """Closed-form terms (1b/2b/3b/dispersion); differentiable."""
        cfg = self.config
        sys_ = self.system
        pos = compute_virtual_sites(sys_, positions)
        parts = {}
        if 'one_body' in cfg.terms:
            parts['one_body'] = torch.sum(one_body_energy(water_positions(sys_, pos)))
        pl, tl = nlists if nlists is not None else (None, None)
        if 'two_body' in cfg.terms:
            parts['two_body'] = (two_body_energy(sys_, pos, pl[0], pl[1]) if pl is not None
                                 else two_body_energy(sys_, pos))
        if 'three_body' in cfg.terms:
            parts['three_body'] = (three_body_energy(sys_, pos, tl[0], tl[1])
                                   if tl is not None else three_body_energy(sys_, pos))
        if 'dispersion' in cfg.terms:
            parts['dispersion'] = dispersion_energy(
                sys_, pos, cutoff=cfg.cutoff, switch_width=cfg.dispersion_switch_width)
        return parts

    def _energy_forces_impl(self, positions, mu0=None, nlists=None):
        """(total energy, forces, parts, diag). mu0: optional induced-dipole
        predictor/warm start; nlists: optional prebuilt lists from
        `build_neighbor_lists` (valid for any superset of the physical
        lists)."""
        sys_ = self.system
        positions = make_molecules_whole(sys_, positions.detach())

        diag = {}
        if nlists is None and self.use_neighbor_lists:
            pl, tl, diag = self._neighbor_lists(positions)
            nlists = (pl, tl)

        with torch.enable_grad():
            p = positions.clone().requires_grad_(True)
            parts = self._smooth_terms(p, nlists)
            total = sum(parts.values()) if parts else torch.zeros((), dtype=p.dtype,
                                                                   device=p.device)
            grad = (torch.autograd.grad(total, p)[0] if total.requires_grad
                    else torch.zeros_like(p))
        forces = -grad
        parts = {k: v.detach() for k, v in parts.items()}
        energy = total.detach()

        if self.elec_params is not None:
            pos_v = compute_virtual_sites(sys_, positions)
            with torch.no_grad():
                e_elec, f_elec, ediag = pme_mod.pme_electrostatics(
                    self.elec_params, self.pme, pos_v, mu0=mu0)
            diag.update(ediag)
            parts['electrostatics'] = e_elec
            # redistribute M-site forces to the parents (average3 weights)
            w = _data.load('forcefield')['vsite_weights']
            f4 = f_elec.reshape(sys_.n_waters, 4, 3)
            f_m = f4[:, 3]
            f4 = torch.stack([f4[:, 0] + float(w[0]) * f_m,
                              f4[:, 1] + float(w[1]) * f_m,
                              f4[:, 2] + float(w[2]) * f_m,
                              torch.zeros_like(f_m)], dim=1)
            forces = forces + f4.reshape(-1, 3)
            energy = energy + e_elec
        return energy, forces, parts, diag

    def energy_forces(self, positions, mu0=None):
        """(total energy kJ/mol, forces kJ/mol/nm [natoms,3], per-term
        energies, diagnostics). Pass a previous diag['induced_dipoles'] as
        mu0 to warm-start the SCF."""
        return self._energy_forces_impl(positions, mu0=mu0)

