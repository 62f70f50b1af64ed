"""The full MB-pol potential (port of mbpol_openmm_plugin_tpu/models/potential.py).

Positions of the real atoms in, per-term energies and total forces out.
The smooth terms (one-body, 2B/3B PIPs, dispersion, the cluster restraint)
get their forces from torch.autograd through the M-site placement; the
electrostatic forces are explicit and the M-site share is redistributed
with the average3 weights.

Accepted here: PME boxes and NoCutoff clusters (the cluster electrostatics
of models/electrostatics.py); water-only systems, water + Cl- systems
without the electrostatics term (the force field defines no ion
electrostatics), and layouts other than the stride-4 OHHM block;
electrostatics_mode 'auto', 'dense' or 'block' (block-sparse direct space
for large PME boxes); dispersion_mode 'auto', 'dense' or 'pairs';
scf_method 'sor', 'diis' or 'aspc'; the flat-bottom restraint of clusters
(restraint_radius); analytic list capacities or capacities tuned from a
configuration (`tune_capacities`). 'auto' resolves as the JAX package does:
dense up to 2560 waters where the CUDA kernels run (the potential's device
is a card), 512 otherwise; above that 'block' with the kernels and 'sparse'
without, and 'pairs' dispersion whenever the electrostatics leave 'dense'.
'sparse' raises NotImplementedError (see ROADMAP.md). The box is an
argument of each evaluation (`box`, default the system's), for the
barostat.

The potential lives on one device (`device`, default 'cuda'; the tests
pass 'cpu'): its entry points take numpy arrays or tensors and move them
there. Without a card, the default device raises; nothing falls back.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch import ROADMAP_HINT, _data
from mbpol_openmm_plugin_tpu_torch.models import electrostatics as elec
from mbpol_openmm_plugin_tpu_torch.models import pme as pme_mod
from mbpol_openmm_plugin_tpu_torch.models.dispersion import (PAIR_MARGIN, dispersion_energy,
                                                              dispersion_energy_pairs)
from mbpol_openmm_plugin_tpu_torch.models.one_body import one_body_energy
from mbpol_openmm_plugin_tpu_torch.models.restraint import flat_bottom_energy
from mbpol_openmm_plugin_tpu_torch.models.three_body import three_body_energy
from mbpol_openmm_plugin_tpu_torch.models.two_body import two_body_energy
from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as bs
from mbpol_openmm_plugin_tpu_torch.ops import neighbors, polyeval
from mbpol_openmm_plugin_tpu_torch.system import (System, _standard_layout,
                                                  compute_virtual_sites, index_tensor,
                                                  make_molecules_whole, oxygen_positions,
                                                  water_positions)

# 'auto' keeps the dense direct space up to this many waters (the JAX
# package's limits): with the CUDA kernels the only O(N^2) memory is
# s3/s5/delta, ~44 bytes per site pair; without them the plain twins
# materialize ~35 [N, N] tensors.
DENSE_LIMIT_KERNELS = 2560
DENSE_LIMIT = 512


@dataclasses.dataclass(frozen=True)
class MBPolConfig:
    """Static evaluation options: the JAX package's MBPolConfig fields that
    the port uses, with the same defaults (list compaction and the
    reference triplet semantics are not ported).

    `pip_impl` picks the evaluator of the 2B/3B polynomials, `pip_basis`
    the basis construction of the 'quad' impl (ops/polyeval.pip_apply):
    pip_impl None or 'quad' (the default, plain PyTorch quadratic form),
    'monomial' (plain monomial expansion), or a fused CUDA kernel of
    ops/pip_fused.py: 'pallas' (monomial), 'quad_pallas' (quadratic form,
    exp/log basis), 'quad_bf16' (exact-product basis), 'vech_pallas' (vech
    basis); pip_basis None or 'gather', 'bf16x3', 'vech'. The names are the
    JAX package's; on CPU tensors a fused impl evaluates its plain twin."""
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
    pip_impl: Optional[str] = None
    pip_basis: Optional[str] = None
    # flat-bottom restraint of the oxygens about their instantaneous
    # centroid (models/restraint.py): radius in nm (None: off), k in
    # kJ/mol/nm^2; non-periodic systems only
    restraint_radius: Optional[float] = None
    restraint_k: float = 1000.0
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
    if config.restraint_radius is not None and system.periodic:
        # the instantaneous-centroid restraint is ill-defined under PBC
        raise ValueError('restraint_radius is a cluster (non-periodic) feature')
    if 'electrostatics' in config.terms and system.n_ions:
        raise ValueError('MB-pol electrostatics supports water-only systems (the force field '
                         'defines no ion electrostatics parameters); drop "electrostatics" from '
                         'MBPolConfig.terms to evaluate the other terms with ions')
    if config.electrostatics_mode not in ('auto', 'dense', 'block', 'sparse'):
        raise ValueError(f'unknown electrostatics_mode {config.electrostatics_mode!r}')
    if config.dispersion_mode not in ('auto', 'dense', 'pairs'):
        raise ValueError(f'unknown dispersion_mode {config.dispersion_mode!r}')
    polyeval._pip_impl_choice(config.pip_impl, config.pip_basis)   # raises on unknown values
    if config.scf_method not in ('sor', 'diis', 'aspc'):
        raise ValueError(f'unknown scf_method {config.scf_method!r}')


def resolve_modes(system: System, config: MBPolConfig, has_pme, kernels):
    """(electrostatics mode, dispersion mode) after resolving 'auto' as JAX
    MBPol.__init__ does; `kernels`: the direct-space CUDA kernels run (the
    device is a card), the counterpart of elec_pallas.use_pallas."""
    mode = config.electrostatics_mode
    if mode == 'auto':
        dense_limit = DENSE_LIMIT_KERNELS if kernels else DENSE_LIMIT
        if has_pme and system.n_waters > dense_limit:
            mode = 'block' if kernels else 'sparse'
        else:
            mode = 'dense'
    dmode = config.dispersion_mode
    if dmode == 'auto':
        # leave the dense [N,N] site grid exactly when electrostatics did
        dmode = ('pairs' if mode in ('sparse', 'block') and system.periodic
                 and system.n_ions == 0 and 'dispersion' in config.terms else 'dense')
    return mode, dmode


class MBPol:
    """MB-pol potential for a fixed topology.

        pot = MBPol(system, MBPolConfig(nonbonded_method='PME'))   # on the card
        energy, forces, parts, diag = pot.energy_forces(positions)

    `positions` are [natoms, 3] nm including M-site slots (overwritten by
    the virtual-site placement), as a numpy array or a tensor; they are
    moved to `device` in its dtype (float32 on a card, where the kernels
    run, float64 on the CPU).
    """

    def __init__(self, system: System, config: MBPolConfig = MBPolConfig(), device='cuda'):
        _check_config(system, config)
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError("MBPol: no CUDA device is available; pass device='cpu' to "
                               'evaluate on the CPU')
        self.dtype = torch.float32 if self.device.type == 'cuda' else torch.float64
        self.system = system
        self.config = config
        self.elec_params = None
        self.pme = None
        self._tables = None
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
            if config.nonbonded_method == 'PME':
                self.pme = pme_mod.PmeSetup.from_config(system, config)
        self.elec_mode, self.disp_mode = resolve_modes(
            system, config, self.pme is not None, kernels=self.device.type == 'cuda')
        self._block_info = None
        if self.elec_mode == 'sparse':
            raise _not_ported(f"{system.n_waters} waters: electrostatics_mode='sparse' (the "
                              'large-box mode without the CUDA kernels)')
        if self.elec_mode == 'block':
            if self.pme is None:
                raise ValueError('block electrostatics requires PME')
            if not _standard_layout(system):
                raise ValueError('block electrostatics requires the stride-4 water layout')
            # identity permutation until tune_capacities sees real positions;
            # correctness never depends on the sort (only the tile-pair count)
            n_sites = 4 * system.n_waters
            self._set_block_perm(np.arange(n_sites),
                                 bs.tile_pair_capacity(n_sites, system.box, config.cutoff))
        self.disp_pair_cut = self.disp_pair_cap = None
        if self.disp_mode == 'pairs':
            if not system.periodic or system.n_ions:
                raise ValueError("dispersion_mode='pairs' requires a periodic water-only system")
            self.disp_pair_cut = config.cutoff + PAIR_MARGIN + config.nlist_skin
            self.disp_pair_cap = neighbors.pair_capacity(
                system.n_waters, system.box, self.disp_pair_cut,
                factor=config.neighbor_capacity_factor)
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

    def _set_block_perm(self, site_perm, cap, line_cap=None):
        self._block_info = pme_mod.block_info(site_perm, cap, self.device, line_cap)

    def _site_tables(self):
        """The electrostatics parameters' per-site tables on the device,
        rebuilt when elec_params is replaced (convert.from_jax_arrays)."""
        if self._tables is None or self._tables[0] is not self.elec_params:
            self._tables = (self.elec_params,
                            pme_mod.site_tables(self.elec_params, self.dtype, self.device))
        return self._tables[1]

    def as_positions(self, positions):
        """positions (numpy or tensor) as a tensor on the potential's device
        and dtype."""
        return torch.as_tensor(positions, dtype=self.dtype, device=self.device)

    def _neighbor_lists(self, positions, box=None):
        """Padded pair/triplet lists from the O positions, cutoffs + skin, in
        `box` (default the system's; the capacities and the triplet build's
        shape stay those of the construction box or tune_capacities).
        Returns ((pairs, pmask), (trips, tmask), diag with overflow flags)."""
        sys_ = self.system
        o_pos = oxygen_positions(sys_, positions)
        box = sys_.box if box is None else box
        skin = self.config.nlist_skin
        pairs, pmask, n_p = neighbors.pair_list(o_pos, box,
                                                self.config.cutoff_2b + skin, self.pair_cap)
        k_max = self.nlist_k_max
        if k_max is None:
            k_max = neighbors.max_neighbors(sys_.n_waters, sys_.box,
                                            self.config.cutoff_3b + skin)
        trips, tmask, n_t = neighbors.triplet_list(
            o_pos, box, self.config.cutoff_3b + skin, self.trip_cap,
            k_max=k_max, kt=self.nlist_kt)
        diag = dict(n_pairs=n_p, n_triplets=n_t,
                    pair_overflow=n_p > self.pair_cap,
                    triplet_overflow=n_t > self.trip_cap)
        return (pairs, pmask), (trips, tmask), diag

    def build_neighbor_lists(self, positions, box=None):
        """Lists for reuse across MD steps (pair with nlist_skin > 0), built
        on the potential's device in `box` (default the system's). Returns
        ((pl, tl), diag)."""
        pl, tl, diag = self._neighbor_lists(
            make_molecules_whole(self.system, self.as_positions(positions), box), box)
        return (pl, tl), diag

    def _smooth_terms(self, positions, nlists=None, disp_pairs=None, box=None):
        """Closed-form terms (1b/2b/3b/dispersion) in `box` (default the
        system's); differentiable."""
        cfg = self.config
        sys_ = self.system
        pos = compute_virtual_sites(sys_, positions)
        parts = {}
        if 'one_body' in cfg.terms:
            parts['one_body'] = torch.sum(one_body_energy(water_positions(sys_, pos)))
        pl, tl = nlists if nlists is not None else ((None, None), (None, None))
        pip = (cfg.pip_impl, cfg.pip_basis)
        if 'two_body' in cfg.terms:
            parts['two_body'] = two_body_energy(sys_, pos, pl[0], pl[1], box=box, pip=pip)
        if 'three_body' in cfg.terms:
            parts['three_body'] = three_body_energy(sys_, pos, tl[0], tl[1], box=box, pip=pip)
        if 'dispersion' in cfg.terms:
            sw = cfg.dispersion_switch_width
            if disp_pairs is not None:
                parts['dispersion'] = dispersion_energy_pairs(
                    sys_, pos, disp_pairs[0], disp_pairs[1], cutoff=cfg.cutoff, box=box,
                    switch_width=sw)
            else:
                parts['dispersion'] = dispersion_energy(sys_, pos, cutoff=cfg.cutoff, box=box,
                                                        switch_width=sw)
        if cfg.restraint_radius is not None:
            parts['restraint'] = flat_bottom_energy(oxygen_positions(sys_, pos),
                                                    cfg.restraint_radius, cfg.restraint_k)
        return parts

    def _lists(self, positions, box, nlists=None):
        """(nlists, disp_pairs, diag) of an evaluation at whole positions in
        `box` (host floats): the pair and triplet lists (`nlists` when
        given), the dispersion water-pair list and their overflow flags."""
        diag = {}
        if nlists is None and self.use_neighbor_lists:
            pl, tl, diag = self._neighbor_lists(positions, box)
            nlists = (pl, tl)
        disp_pairs = None
        if self.disp_mode == 'pairs' and 'dispersion' in self.config.terms:
            # water-pair list at cutoff + PAIR_MARGIN (+ skin), every evaluation
            o_pos = oxygen_positions(self.system, positions)
            mp, mp_mask, n_mp = neighbors.pair_list(o_pos, box, self.disp_pair_cut,
                                                    self.disp_pair_cap)
            diag = dict(diag, disp_pair_overflow=n_mp > self.disp_pair_cap)
            disp_pairs = (mp, mp_mask)
        return nlists, disp_pairs, diag

    def _energy_forces_impl(self, positions, mu0=None, nlists=None, box=None):
        """(total energy, forces, parts, diag). mu0: optional induced-dipole
        predictor/warm start; nlists: optional prebuilt lists from
        `build_neighbor_lists` (valid for any superset of the physical
        lists); box: the box of this evaluation, three floats on the host
        (default the system's, with the same bits as passing it), for a
        barostat. The PME grid and alpha and every list capacity stay at
        their construction (or tune_capacities) values; a box shorter than
        twice the cutoff raises."""
        sys_ = self.system
        box = sys_.box if box is None else np.asarray(box, np.float64)
        positions = make_molecules_whole(sys_, self.as_positions(positions).detach(), box)

        nlists, disp_pairs, diag = self._lists(positions, box, nlists)
        with torch.enable_grad():
            p = positions.clone().requires_grad_(True)
            parts = self._smooth_terms(p, nlists, disp_pairs, box)
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
                if self.pme is None:
                    e_elec, f_elec, ediag = elec.cluster_electrostatics(self.elec_params, pos_v,
                                                                        mu0=mu0)
                else:
                    e_elec, f_elec, ediag = pme_mod.pme_electrostatics(
                        self.elec_params, self.pme, pos_v, mu0=mu0, block=self._block_info,
                        tables=self._site_tables(), box=box)
            diag.update(ediag)
            parts['electrostatics'] = e_elec
            forces = forces + _redistribute_m_sites(sys_, f_elec)
            energy = energy + e_elec
        return energy, forces, parts, diag

    def energy_forces(self, positions, mu0=None, box=None):
        """(total energy kJ/mol, forces kJ/mol/nm [natoms,3], per-term
        energies, diagnostics). Pass a previous diag['induced_dipoles'] as
        mu0 to warm-start the SCF, and a box (three floats, nm) to evaluate
        in another box than the system's."""
        return self._energy_forces_impl(positions, mu0=mu0, box=box)

    def tune_capacities(self, positions, margin=1.15):
        """Size the padded lists from the exact neighbor counts of a
        representative configuration, with a safety margin for density
        fluctuations, as the JAX MBPol.tune_capacities does (the port's own
        torch counts in place of the native voxel hash): pair_cap,
        trip_cap, nlist_k_max, nlist_kt, disp_pair_cap, and in block mode
        the serpentine site sort, the tile-pair capacity and the s3/s5 line
        capacity (from the most live lines of one (row water, cluster)
        slab, at most the number of column tiles). Overflow later
        in a run still shows in diag['*_overflow']. Returns self."""
        if not self.use_neighbor_lists:
            return self
        sys_, cfg = self.system, self.config
        pos = make_molecules_whole(sys_, self.as_positions(positions))
        o = oxygen_positions(sys_, pos)
        box, skin, n_w = sys_.box, cfg.nlist_skin, sys_.n_waters
        n_p, _, _ = neighbors.neighbor_counts(o, box, cfg.cutoff_2b + skin)
        _, degree, per_center = neighbors.neighbor_counts(o, box, cfg.cutoff_3b + skin,
                                                          triplets=True)
        n_t = int(torch.sum(per_center))
        self.pair_cap = max(int(margin * n_p) + 16, 64)
        self.trip_cap = max(int(margin * n_t) + 32, 128)
        # per-center triplet-build shape parameters from the actual counts;
        # the factors scale with the margin as the global caps do
        max_nbr = int(torch.max(degree)) if n_w else 0
        f_k, f_kt = max(1.3, float(margin)), max(1.4, float(margin))
        self.nlist_k_max = min(max(int(np.ceil(f_k * max_nbr)) + 2, 8), max(n_w - 1, 1))
        max_ct = int(torch.max(per_center)) if n_w else 0
        self.nlist_kt = min(int(np.ceil(f_kt * max_ct)) + 8,
                            self.nlist_k_max * (self.nlist_k_max - 1) // 2)
        if self.disp_mode == 'pairs':
            n_d, _, _ = neighbors.neighbor_counts(o, box, self.disp_pair_cut)
            self.disp_pair_cap = max(int(margin * n_d) + 16, 64)
        if self.elec_mode == 'block':
            mol_perm = bs.molecule_sort_permutation(o.detach().cpu().numpy(), box)
            site_perm = (4 * mol_perm[:, None] + np.arange(4)[None, :]).reshape(-1)
            # count the active tile pairs at the sorted layout with a list
            # that holds every tile pair
            n_sites = 4 * n_w
            n_tiles = bs.padded(n_sites) // bs.TILE
            pos_s = bs.pad_rows(pos[torch.as_tensor(site_perm, device=pos.device)],
                                bs.padded(n_sites))
            full = bs.active_tile_pairs(pos_s, n_sites, box, cfg.cutoff, n_tiles * n_tiles)
            n_act = int(full.n_act)
            # and the live s3/s5 lines per (row water, cluster) slab, at the
            # sites' positions with the M sites placed
            pos_v = bs.pad_rows(compute_virtual_sites(sys_, pos)[
                torch.as_tensor(site_perm, device=pos.device)], bs.padded(n_sites))
            _, count = bs.line_slots(bs.live_lines(pos_v, n_sites, full, box, cfg.cutoff), full)
            max_lines = int(torch.max(count))
            self._set_block_perm(site_perm, max(int(margin * n_act) + 8, 16),
                                 min(max(int(margin * max_lines) + 2, 8), n_tiles))
        return self


def _redistribute_m_sites(system: System, f):
    """Forces [natoms, 3] with each M-site row moved to its parents O, H1, H2
    with the average3 weights (a reshape on the standard layout; the index
    rows are unique otherwise, so the scatter has no collisions)."""
    w = [float(x) for x in _data.load('forcefield')['vsite_weights']]
    if _standard_layout(system):
        f4 = f.reshape(system.n_waters, 4, 3)
        f_m = f4[:, 3]
        f4 = torch.stack([f4[:, 0] + w[0] * f_m, f4[:, 1] + w[1] * f_m,
                          f4[:, 2] + w[2] * f_m, torch.zeros_like(f_m)], dim=1)
        return f4.reshape(-1, 3)
    m_rows = index_tensor(system.m_index, f)
    f_m = f[m_rows]
    f = f.index_put((m_rows,), torch.zeros_like(f_m))
    for wk, idx in zip(w, (system.o_index, system.h1_index, system.h2_index)):
        f = f.index_add(0, index_tensor(idx, f), wk * f_m)
    return f


def with_scf_method(pot: MBPol, method: str, aspc_n_corr: Optional[int] = None,
                    target_epsilon: Optional[float] = None,
                    scf_eps_floor: Optional[float] = None,
                    max_iterations: Optional[int] = None):
    """A new MBPol over the same topology, device, lists, capacities and
    block layout with another SCF closure ('sor' | 'diis' | 'aspc') and,
    when given, another ASPC corrector depth, SCF target, float32 floor of
    the target or iteration cap, as the JAX function of that name. A cold
    single point converges to the same fixed point under each closure, so
    only a trajectory changes: Simulation's scf='auto' runs a SOR
    potential's dynamics under the ASPC closure, and md/pressure.py takes
    its derivative at a tightly converged SOR point."""
    if pot.elec_params is None:
        return pot
    if method not in ('sor', 'diis', 'aspc'):
        raise ValueError(f'unknown scf_method {method!r}')
    changes = dict(scf_method=method)
    for name, value, kind in (('aspc_n_corr', aspc_n_corr, int),
                              ('target_epsilon', target_epsilon, float),
                              ('scf_eps_floor', scf_eps_floor, float),
                              ('max_iterations', max_iterations, int)):
        if value is not None:
            changes[name] = kind(value)
    new = object.__new__(MBPol)
    new.__dict__.update(pot.__dict__)
    new.config = dataclasses.replace(pot.config, **changes)
    new.elec_params = dataclasses.replace(pot.elec_params, **changes)
    return new


def inherit_capacities(src: MBPol, dst: MBPol):
    """dst takes src's tuned list capacities, triplet-build shape and block
    layout (both over the same topology), as the JAX function of that name:
    the term-subset potentials of r-RESPA keep the parent's tune_capacities
    operating point instead of the analytic bounds. Returns dst."""
    for attr in ('pair_cap', 'trip_cap', 'nlist_k_max', 'nlist_kt', 'disp_pair_cap',
                 '_block_info'):
        if hasattr(src, attr):
            setattr(dst, attr, getattr(src, attr))
    return dst
