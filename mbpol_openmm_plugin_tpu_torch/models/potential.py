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
electrostatics_mode 'auto', 'dense', 'block' (block-sparse direct space
for large PME boxes, with the CUDA kernels) or 'sparse' (the water-pair
list direct space of models/pme_sparse.py, plain PyTorch);
dispersion_mode 'auto', 'dense' or 'pairs'; scf_method 'sor', 'diis' or
'aspc'; the flat-bottom restraint of clusters (restraint_radius); list
compaction (compact_eval) and the reference's triplet enumeration
(triplet_semantics); analytic list capacities, capacities tuned from a
configuration (`tune_capacities`, from the port's own counts or the host
voxel hash of ops/native.py) or a `parallel.plan.CapacityPlan` (`plan=`).
'auto' resolves as the JAX package does: dense up to 2560 waters (2560 x
max(shards // 2, 1) under a mesh) where the CUDA kernels run (the
potential's device is a card), 512 otherwise; above that 'block' with the
kernels and 'sparse' without, and 'pairs' dispersion whenever the
electrostatics leave 'dense'. The box is an argument of each evaluation
(`box`, default the system's), for the barostat.

The potential lives on one device (`device`, default 'cuda'; the tests
pass 'cpu'): its entry points take numpy arrays or tensors and move them
there. Without a card, the default device raises; nothing falls back.
With a device mesh (`mesh`, parallel/mesh.py) the device is the mesh's
lead: the one-body molecule batch, the 2B pair and 3B triplet batches,
the dispersion rows or pairs and the electrostatics (dense rows, block row
tiles, sparse pairs, cluster rows, the PME grid's sites) split over its
shards, each shard's share evaluated on its device (a fused `pip_impl`
launches its kernel once per shard), the energies added on the lead in
shard order. Every list capacity is a multiple of the shard count.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch import _data
from mbpol_openmm_plugin_tpu_torch.models import electrostatics as elec
from mbpol_openmm_plugin_tpu_torch.models import pme as pme_mod
from mbpol_openmm_plugin_tpu_torch.models import pme_sparse
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
from mbpol_openmm_plugin_tpu_torch.utils import tracing

# 'auto' keeps the dense direct space up to this many waters (the JAX
# package's limits): with the CUDA kernels the only O(N^2) memory is
# s3/s5/delta, ~44 bytes per site pair; without them the plain twins
# materialize ~35 [N, N] tensors.
DENSE_LIMIT_KERNELS = 2560
DENSE_LIMIT = 512


@dataclasses.dataclass(frozen=True)
class MBPolConfig:
    """Static evaluation options: the JAX package's MBPolConfig fields that
    the port uses, with the same defaults.

    `compact_eval` shrinks the skin-inflated 2B/3B batches before the
    polynomials (exact: the dropped entries have zero switch weight or sit
    inside the r < 2 A early exit): None or False (off), True (every
    evaluation, to the physical cutoffs) or 'rebuild' (at each list build,
    to cutoff + skin / 2, exact under the displacement trigger; the
    port builds its lists in every MD step and selects them with the
    trigger, so the compaction runs in every step too). `triplet_semantics`
    is 'complete' (every triplet with >= 2 O-O edges) or 'reference' (the
    reference's ascending chains, ops/neighbors.py); compaction is off under
    'reference', whose list depends on the numbering.

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
    compact_eval: Optional[object] = None
    triplet_semantics: str = 'complete'
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
    if config.triplet_semantics not in ('complete', 'reference'):
        raise ValueError(f'unknown triplet_semantics {config.triplet_semantics!r}')


def resolve_modes(system: System, config: MBPolConfig, has_pme, kernels, n_devices=1):
    """(electrostatics mode, dispersion mode) after resolving 'auto' as JAX
    MBPol.__init__ does; `kernels`: the direct-space CUDA kernels run (the
    device is a card), the counterpart of elec_pallas.use_pallas;
    n_devices: the mesh's shards, whose row split of the dense s3/s5
    stretches the dense limit."""
    mode = config.electrostatics_mode
    if mode == 'auto':
        dense_limit = (DENSE_LIMIT_KERNELS * max(n_devices // 2, 1) if kernels
                       else DENSE_LIMIT)
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
    run, float64 on the CPU). `mesh`: a parallel.mesh.Mesh to split the
    evaluation over (its lead device is the potential's; `device` may be
    left out). `plan`: a parallel.plan.CapacityPlan for as many devices as
    the mesh has shards (one without a mesh), whose capacities (and block
    layout) the potential takes.
    """

    def __init__(self, system: System, config: MBPolConfig = MBPolConfig(), device=None,
                 mesh=None, plan=None):
        with tracing.phase('models.potential.init'):
            _check_config(system, config)
            if mesh is not None:
                if device is not None and torch.device(device) != mesh.lead:
                    raise ValueError(f'device {device} is not the mesh lead {mesh.lead}')
                device = mesh.lead
            self.mesh = mesh
            self.device = torch.device('cuda' if device is None else device)
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
                system, config, self.pme is not None, kernels=self.device.type == 'cuda',
                n_devices=self._n_shards())
            self._block_info = None
            if self.elec_mode in ('block', 'sparse'):
                if self.pme is None:
                    raise ValueError(f'{self.elec_mode} electrostatics requires PME')
                if not _standard_layout(system):
                    raise ValueError(f'{self.elec_mode} electrostatics requires the stride-4 water '
                                     'layout')
            if self.elec_mode == 'block':
                # identity permutation until tune_capacities sees real positions;
                # correctness never depends on the sort (only the tile-pair count)
                n_sites = 4 * system.n_waters
                self._set_block_perm(np.arange(n_sites),
                                     bs.tile_pair_capacity(n_sites, system.box, config.cutoff))
            # one water-pair list at cutoff + PAIR_MARGIN (+ skin) serves the
            # sparse electrostatics and the 'pairs' dispersion
            self.water_pair_cut = config.cutoff + PAIR_MARGIN + config.nlist_skin
            self.elec_pair_cap = self.disp_pair_cap = None
            if self.elec_mode == 'sparse':
                self.elec_pair_cap = neighbors.pair_capacity(
                    system.n_waters, system.box, self.water_pair_cut,
                    factor=config.neighbor_capacity_factor)
            if self.disp_mode == 'pairs':
                if not system.periodic or system.n_ions:
                    raise ValueError("dispersion_mode='pairs' requires a periodic water-only "
                                     'system')
                if self.elec_mode != 'sparse':      # else the electrostatics' list
                    self.disp_pair_cap = neighbors.pair_capacity(
                        system.n_waters, system.box, self.water_pair_cut,
                        factor=config.neighbor_capacity_factor)
            use_nl = config.use_neighbor_lists
            self.use_neighbor_lists = system.n_waters > 24 if use_nl is None else use_nl
            ce = False if config.compact_eval is None else config.compact_eval
            if not (self.use_neighbor_lists and config.triplet_semantics == 'complete'):
                ce = False
            if ce not in (False, True, 'rebuild'):
                raise ValueError(f"compact_eval must be False, True or 'rebuild', got {ce!r}")
            self.compact_eval = ce
            # triplet-build shape parameters (None = analytic bound)
            self.nlist_k_max = None
            self.nlist_kt = None
            if self.use_neighbor_lists:
                box, f = system.box, config.neighbor_capacity_factor
                self.pair_cap = neighbors.pair_capacity(
                    system.n_waters, box, config.cutoff_2b + config.nlist_skin, factor=f)
                self.trip_cap = neighbors.triplet_capacity(
                    system.n_waters, box, config.cutoff_3b + config.nlist_skin, factor=f)
                # the compacted batches: at the physical cutoffs, or at cutoff +
                # skin / 2 for compaction at the list build
                half = self._compact_half()
                self.pair_eval_cap = neighbors.pair_capacity(
                    system.n_waters, box, config.cutoff_2b + half, factor=f)
                self.trip_eval_cap = neighbors.triplet_capacity(
                    system.n_waters, box, config.cutoff_3b + half, factor=f)
            self._round_capacities()
            if plan is not None:
                self._apply_plan(plan)

    def _n_shards(self):
        return 1 if self.mesh is None else self.mesh.size

    def _round_capacities(self):
        """Round every list capacity up to a multiple of the shard count
        (the JAX MBPol under a mesh), so each shard's slab is the same
        size."""
        from mbpol_openmm_plugin_tpu_torch.parallel.mesh import round_up
        k = self._n_shards()
        for attr in ('pair_cap', 'trip_cap', 'pair_eval_cap', 'trip_eval_cap', 'elec_pair_cap',
                     'disp_pair_cap'):
            v = getattr(self, attr, None)
            if v is not None:
                setattr(self, attr, round_up(v, k))

    def _compact_half(self):
        """The radius added to the physical cutoffs for the compacted
        batches: skin / 2 under 'rebuild', else 0."""
        return 0.5 * self.config.nlist_skin if self.compact_eval == 'rebuild' else 0.0

    def _apply_plan(self, plan):
        """Take a parallel.plan.CapacityPlan's capacities (and block layout),
        as the JAX MBPol's constructor does; the plan's device count must be
        the mesh's shard count (1 without a mesh)."""
        if plan.n_devices != self._n_shards():
            raise ValueError(f'plan is for {plan.n_devices} devices, potential mesh has '
                             f'{self._n_shards()}')
        if self.system.n_waters != plan.n_waters:
            raise ValueError('plan/potential water count mismatch')
        if not self.use_neighbor_lists:
            return
        self.pair_cap, self.trip_cap = plan.pair_cap, plan.trip_cap
        if self.compact_eval and self.config.nlist_skin > 0:
            self.pair_eval_cap, self.trip_eval_cap = plan.pair_eval_cap, plan.trip_eval_cap
        else:
            self.pair_eval_cap, self.trip_eval_cap = self.pair_cap, self.trip_cap
        self.nlist_k_max, self.nlist_kt = plan.nlist_k_max, plan.nlist_kt
        if plan.elec_pair_cap and self.elec_mode == 'sparse':
            self.elec_pair_cap = plan.elec_pair_cap
        if plan.disp_pair_cap and self.disp_pair_cap is not None:
            self.disp_pair_cap = plan.disp_pair_cap
        if plan.tile_pair_capacity and self.elec_mode == 'block':
            info = self._block_info
            self._set_block_perm(info['site_perm'] if plan.site_perm is None else plan.site_perm,
                                 plan.tile_pair_capacity,
                                 plan.line_capacity or info['line_capacity'],
                                 plan.tile_pair_capacity_local)

    def _set_block_perm(self, site_perm, cap, line_cap=None, cap_local=None):
        self._block_info = pme_mod.block_info(site_perm, cap, self.device, line_cap, cap_local)

    def to_device(self, device):
        """A clone of this potential on `device` (its own device too) with
        the same configuration, capacities and block layout, whose per-site
        tables are rebuilt there at first use. The beads and replicas of
        md/rpmd.py and md/remd.py run on their shards' devices through such
        copies, one per shard. A meshed potential stays on its mesh."""
        device = torch.device(device)
        if self.mesh is not None:
            raise ValueError('a meshed potential runs on its mesh; build it with another mesh')
        new = object.__new__(MBPol)
        new.__dict__.update(self.__dict__)
        new.device, new._tables = device, None
        if self._block_info is not None:
            info = self._block_info
            new._block_info = pme_mod.block_info(info['site_perm'], info['tile_pair_capacity'],
                                                 device, info['line_capacity'],
                                                 info['tile_pair_capacity_local'])
        return new

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
        shape stay those of the construction box or tune_capacities); under
        compact_eval='rebuild' compacted to cutoff + skin / 2 at the eval
        capacities (exact under the displacement trigger: between builds no
        pair distance moves by more than skin / 2), the compaction's
        overflow folded into the list's. Returns ((pairs, pmask), (trips,
        tmask), diag with overflow flags)."""
        sys_, cfg = self.system, self.config
        o_pos = oxygen_positions(sys_, positions)
        box = sys_.box if box is None else box
        skin = cfg.nlist_skin
        pairs, pmask, n_p = neighbors.pair_list(o_pos, box, cfg.cutoff_2b + skin, self.pair_cap)
        k_max = self.nlist_k_max
        if k_max is None:
            k_max = neighbors.max_neighbors(sys_.n_waters, sys_.box, cfg.cutoff_3b + skin)
        trips, tmask, n_t = neighbors.triplet_list(
            o_pos, box, cfg.cutoff_3b + skin, self.trip_cap, k_max=k_max, kt=self.nlist_kt,
            semantics=cfg.triplet_semantics)
        pair_ovf, trip_ovf = n_p > self.pair_cap, n_t > self.trip_cap
        if self.compact_eval == 'rebuild':
            half = self._compact_half()
            b = box if sys_.periodic else None
            rmin = 0.2 - half       # the 2 A early exit, less the drift
            pairs, pmask, n_pc = neighbors.compact_pairs(o_pos, b, pairs, pmask,
                                                         cfg.cutoff_2b + half, rmin,
                                                         self.pair_eval_cap)
            trips, tmask, n_tc = neighbors.compact_triplets(o_pos, b, trips, tmask,
                                                            cfg.cutoff_3b + half, rmin,
                                                            self.trip_eval_cap)
            pair_ovf = pair_ovf | (n_pc > self.pair_eval_cap)
            trip_ovf = trip_ovf | (n_tc > self.trip_eval_cap)
        diag = dict(n_pairs=n_p, n_triplets=n_t, pair_overflow=pair_ovf,
                    triplet_overflow=trip_ovf)
        return (pairs, pmask), (trips, tmask), diag

    def _compact_lists(self, positions, nlists, box):
        """Compaction of the (skin-inflated) lists to the entries inside the
        physical cutoffs and above the 2 A early exit, at the eval
        capacities (compact_eval=True, every evaluation). Exact; index only.
        Returns (nlists, diag with the active counts and overflow flags)."""
        sys_, cfg = self.system, self.config
        (pairs, pmask), (trips, tmask) = nlists
        o_pos = oxygen_positions(sys_, positions)
        b = box if sys_.periodic else None
        pairs, pmask, n_p = neighbors.compact_pairs(o_pos, b, pairs, pmask, cfg.cutoff_2b, 0.2,
                                                    self.pair_eval_cap)
        trips, tmask, n_t = neighbors.compact_triplets(o_pos, b, trips, tmask, cfg.cutoff_3b,
                                                       0.2, self.trip_eval_cap)
        diag = dict(n_pairs_active=n_p, n_triplets_active=n_t,
                    pair_eval_overflow=n_p > self.pair_eval_cap,
                    triplet_eval_overflow=n_t > self.trip_eval_cap)
        return ((pairs, pmask), (trips, tmask)), diag

    def build_neighbor_lists(self, positions, box=None, use_native=False):
        """Lists for reuse across MD steps (pair with nlist_skin > 0) in
        `box` (default the system's). Returns ((pl, tl), diag). Built on the
        potential's device, or with use_native=True by the host voxel hash
        of ops/native.py ('complete' triplets only; the lists padded to the
        capacities and copied to the device once; host work, so never
        inside an MD step, where it raises)."""
        pos = make_molecules_whole(self.system, self.as_positions(positions), box)
        if use_native:
            return self._native_neighbor_lists(pos, box)
        pl, tl, diag = self._neighbor_lists(pos, box)
        return (pl, tl), diag

    def _native_neighbor_lists(self, positions, box):
        from mbpol_openmm_plugin_tpu_torch.md.step_graph import in_step
        from mbpol_openmm_plugin_tpu_torch.ops import native
        if in_step():
            raise RuntimeError('the native neighbor lists are host work; build them outside '
                               'the MD step')
        cfg = self.config
        if cfg.triplet_semantics != 'complete':
            raise ValueError("the native triplet list is the 'complete' set")
        sys_ = self.system
        box = sys_.box if box is None else box
        o = oxygen_positions(sys_, positions).detach().cpu().numpy()
        out, diag = [], {}
        for name, fn, cut, cap in (('pair', native.pair_list, cfg.cutoff_2b, self.pair_cap),
                                   ('triplet', native.triplet_list, cfg.cutoff_3b,
                                    self.trip_cap)):
            found_list, found = fn(o, box if sys_.periodic else None, cut + cfg.nlist_skin,
                                   capacity=cap)
            padded = np.zeros((cap, found_list.shape[1]), np.int64)
            padded[:len(found_list)] = found_list
            out.append((torch.as_tensor(padded, device=self.device),
                        torch.as_tensor(np.arange(cap) < found, device=self.device)))
            diag[f'n_{name}s'] = torch.tensor(found, device=self.device)
            diag[f'{name}_overflow'] = torch.tensor(found > cap, device=self.device)
        return tuple(out), diag

    def _smooth_terms(self, positions, nlists=None, disp_pairs=None, box=None):
        """Closed-form terms (1b/2b/3b/dispersion) in `box` (default the
        system's); differentiable."""
        cfg = self.config
        sys_ = self.system
        mesh = self.mesh
        pos = compute_virtual_sites(sys_, positions)
        parts = {}
        if 'one_body' in cfg.terms:
            wpos = water_positions(sys_, pos)
            parts['one_body'] = _over_rows(mesh, wpos.shape[0], pos.device, lambda dev, lo, hi:
                                           torch.sum(one_body_energy(wpos[lo:hi].to(dev))))
        pl, tl = nlists if nlists is not None else ((None, None), (None, None))
        pip = (cfg.pip_impl, cfg.pip_basis)
        for term, fn, (rows, mask) in (('two_body', two_body_energy, pl),
                                       ('three_body', three_body_energy, tl)):
            if term not in cfg.terms:
                continue
            if rows is None:
                parts[term] = fn(sys_, pos, box=box, pip=pip)
            else:
                parts[term] = _over_rows(
                    mesh, rows.shape[0], pos.device,
                    lambda dev, lo, hi, fn=fn, rows=rows, mask=mask: fn(
                        sys_, pos.to(dev), rows[lo:hi].to(dev), mask[lo:hi].to(dev), box=box,
                        pip=pip))
        if 'dispersion' in cfg.terms:
            sw = cfg.dispersion_switch_width
            if disp_pairs is not None:
                parts['dispersion'] = dispersion_energy_pairs(
                    sys_, pos, disp_pairs[0], disp_pairs[1], cutoff=cfg.cutoff, box=box,
                    switch_width=sw, mesh=mesh)
            else:
                parts['dispersion'] = dispersion_energy(sys_, pos, cutoff=cfg.cutoff, box=box,
                                                        switch_width=sw, mesh=mesh)
        if cfg.restraint_radius is not None:
            parts['restraint'] = flat_bottom_energy(oxygen_positions(sys_, pos),
                                                    cfg.restraint_radius, cfg.restraint_k)
        return parts

    def _lists(self, positions, box, nlists=None):
        """(nlists, water_pairs, diag) of an evaluation at whole positions
        in `box` (host floats): the pair and triplet lists (`nlists` when
        given; compacted here under compact_eval=True), the water-pair list
        of the sparse electrostatics and the 'pairs' dispersion (one list,
        built once, None when neither needs it) and their overflow flags."""
        diag = {}
        if nlists is None and self.use_neighbor_lists:
            pl, tl, diag = self._neighbor_lists(positions, box)
            nlists = (pl, tl)
        if nlists is not None and self.compact_eval is True:
            nlists, c_diag = self._compact_lists(positions, nlists, box)
            diag = dict(diag, **c_diag)
        water_pairs = None
        disp = self.disp_mode == 'pairs' and 'dispersion' in self.config.terms
        if disp or self.elec_mode == 'sparse':
            cap = self.elec_pair_cap if self.elec_mode == 'sparse' else self.disp_pair_cap
            mp, mp_mask, n_mp = neighbors.pair_list(oxygen_positions(self.system, positions),
                                                    box, self.water_pair_cut, cap)
            water_pairs = (mp, mp_mask)
            if disp:
                diag['disp_pair_overflow'] = n_mp > cap
            if self.elec_mode == 'sparse':
                diag['elec_pair_overflow'] = n_mp > cap
        return nlists, water_pairs, diag

    def _energy_forces_impl(self, positions, mu0=None, nlists=None, box=None):
        """(total energy, forces, parts, diag). mu0: optional induced-dipole
        predictor/warm start; nlists: optional prebuilt lists from
        `build_neighbor_lists` (valid for any superset of the physical
        lists); box: the box of this evaluation, three floats on the host
        (default the system's, with the same bits as passing it), for a
        barostat. The PME grid and alpha and every list capacity stay at
        their construction (or tune_capacities) values; a box shorter than
        twice the cutoff raises."""
        # the body has a frame of its own, so that freeing its locals (the
        # smooth terms' autograd graph) falls inside the span
        with tracing.span('models.potential.evaluate'):
            return self._evaluate(positions, mu0, nlists, box)

    def _evaluate(self, positions, mu0, nlists, box):
        sys_ = self.system
        box = sys_.box if box is None else np.asarray(box, np.float64)
        positions = make_molecules_whole(sys_, self.as_positions(positions).detach(), box)

        with tracing.span('models.potential.lists'):
            nlists, water_pairs, diag = self._lists(positions, box, nlists)
        disp_pairs = water_pairs if self.disp_mode == 'pairs' else None
        with tracing.span('models.potential.smooth_terms'), torch.enable_grad():
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
            with tracing.span('models.potential.electrostatics'), torch.no_grad():
                if self.pme is None:
                    e_elec, f_elec, ediag = elec.cluster_electrostatics(self.elec_params, pos_v,
                                                                        mu0=mu0, mesh=self.mesh)
                elif self.elec_mode == 'sparse':
                    e_elec, f_elec, ediag = pme_sparse.pme_electrostatics_sparse(
                        self.elec_params, self.pme, pos_v, *water_pairs, mu0=mu0, box=box,
                        tables=self._site_tables(), mesh=self.mesh)
                else:
                    e_elec, f_elec, ediag = pme_mod.pme_electrostatics(
                        self.elec_params, self.pme, pos_v, mu0=mu0, block=self._block_info,
                        tables=self._site_tables(), box=box, mesh=self.mesh)
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

    def energy(self, positions):
        """The total energy (kJ/mol) of a converged evaluation at positions:
        energy_forces(positions)[0]."""
        return self.energy_forces(positions)[0]

    def tune_capacities(self, positions, margin=1.15, native=False):
        """Size the padded lists from the exact neighbor counts of a
        representative configuration, with a safety margin for density
        fluctuations, as the JAX MBPol.tune_capacities does: pair_cap,
        trip_cap, nlist_k_max, nlist_kt, the compacted batches' eval caps,
        elec_pair_cap (sparse), disp_pair_cap, and in block mode the
        serpentine site sort, the tile-pair capacity and the s3/s5 line
        capacity (from the most live lines of one (row water, cluster)
        slab, at most the number of column tiles). The counts are the
        port's own torch counts on the potential's device, or with
        native=True the host voxel hash of ops/native.py (the same
        integers). Overflow later in a run still shows in
        diag['*_overflow']. Returns self."""
        with tracing.phase('models.potential.tune_capacities'):
            if not self.use_neighbor_lists:
                return self
            sys_ = self.system
            pos = make_molecules_whole(sys_, self.as_positions(positions))
            counts = ListCounts(oxygen_positions(sys_, pos), sys_.box, native)
            caps = list_capacities(counts, self.config, sys_.n_waters, margin, self.elec_mode,
                                   self.disp_pair_cap is not None)
            self.pair_cap, self.trip_cap = caps['pair_cap'], caps['trip_cap']
            self.nlist_k_max, self.nlist_kt = caps['nlist_k_max'], caps['nlist_kt']
            if self.compact_eval and self.config.nlist_skin > 0:
                self.pair_eval_cap = caps['pair_eval_cap']
                self.trip_eval_cap = caps['trip_eval_cap']
            else:
                self.pair_eval_cap, self.trip_eval_cap = self.pair_cap, self.trip_cap
            if self.elec_mode == 'sparse':
                self.elec_pair_cap = caps['elec_pair_cap']
            if self.disp_pair_cap is not None:
                self.disp_pair_cap = caps['disp_pair_cap']
            if self.elec_mode == 'block':
                with tracing.phase('models.potential.block_layout'):
                    layout = block_layout(sys_, pos, sys_.box, self.config.cutoff, margin,
                                          self.mesh and self.mesh.size)
                self._set_block_perm(*layout)
            self._round_capacities()
            return self

    def with_updated_params(self, thole=None, charges=None, damping=None, polarity=None,
                            target_epsilon=None, max_iterations=None,
                            include_charge_redistribution=None):
        """updateParametersInContext parity, as the JAX method of that name:
        a new MBPol with mutated electrostatics parameters for the same
        topology, on the same device. List capacities, the PME setup, the
        tuned list sizes and the block layout carry over (the clone of
        `with_scf_method`); a particle-count mismatch raises.

        Array arguments: per-particle [N] charges/damping/polarity, [5]
        thole. Scalars: target_epsilon, max_iterations,
        include_charge_redistribution. The config follows thole and
        include_charge_redistribution, as in the JAX package."""
        if self.elec_params is None:
            raise ValueError('potential has no electrostatics term')
        n = len(self.elec_params.damping)
        changes = {}
        for name, val in (('thole', thole), ('charges', charges),
                          ('damping', damping), ('polarity', polarity)):
            if val is not None:
                val = np.asarray(val, np.float64)
                want = 5 if name == 'thole' else n
                if val.shape != (want,):
                    raise ValueError(
                        f'{name} must have shape ({want},), got {val.shape} (particle count '
                        'must match the existing system, as in updateParametersInContext)')
                changes[name] = val
        if target_epsilon is not None:
            changes['target_epsilon'] = float(target_epsilon)
        if max_iterations is not None:
            changes['max_iterations'] = int(max_iterations)
        if include_charge_redistribution is not None:
            changes['include_charge_redistribution'] = bool(include_charge_redistribution)
        cfg_changes = {k: changes[k] for k in ('include_charge_redistribution',) if k in changes}
        if 'thole' in changes:
            cfg_changes['thole'] = tuple(changes['thole'])
        return _clone(self, cfg_changes, changes)


class ListCounts:
    """Exact neighbor-list counts of O positions o [n, 3] in `box` (None: a
    cluster), for capacity tuning: from the port's own edge matrices on
    o's device (ops/neighbors.neighbor_counts), or with native=True from
    the host voxel hash (ops/native.py). Both give the same integers."""

    def __init__(self, o, box, native=False):
        self.o, self.box, self.native = o, box, native
        self.n = o.shape[0]
        if native:
            self.o_host = o.detach().cpu().numpy().astype(np.float64)

    def _native(self, fn, cutoff):
        from mbpol_openmm_plugin_tpu_torch.ops import native
        found_list, found = getattr(native, fn)(self.o_host, self.box, cutoff)
        if found > len(found_list):          # the default capacity was short
            found_list, found = getattr(native, fn)(self.o_host, self.box, cutoff,
                                                    capacity=found)
        return found_list, found

    def pairs(self, cutoff):
        """Pairs i < j within the cutoff."""
        if self.native:
            return self._native('pair_list', cutoff)[1]
        return neighbors.neighbor_counts(self.o, self.box, cutoff)[0]

    def max_degree(self, cutoff):
        """The most neighbors of one molecule within the cutoff."""
        if self.native:
            pairs = self._native('pair_list', cutoff)[0]
            return int(np.bincount(pairs.ravel(), minlength=self.n).max()) if len(pairs) else 0
        degree = neighbors.neighbor_counts(self.o, self.box, cutoff)[1]
        return int(torch.max(degree)) if self.n else 0

    def triplets(self, cutoff):
        """('complete' triplets within the cutoff, the most of one center)."""
        if self.native:
            trips, found = self._native('triplet_list', cutoff)
            return found, (int(np.bincount(trips[:, 1], minlength=self.n).max())
                           if len(trips) else 0)
        per_center = neighbors.neighbor_counts(self.o, self.box, cutoff, triplets=True)[2]
        return int(torch.sum(per_center)), (int(torch.max(per_center)) if self.n else 0)


def list_capacities(counts: ListCounts, config: MBPolConfig, n_waters, margin, elec_mode,
                    disp_pairs):
    """The tuned capacities of the JAX tune_capacities from exact counts:
    pair_cap, trip_cap, nlist_k_max, nlist_kt (the per-center factors
    scale with the margin as the global caps do), the compacted batches'
    pair_eval_cap / trip_eval_cap (at the physical cutoffs, or + skin / 2
    under compact_eval='rebuild'; at most the list caps), elec_pair_cap
    (elec_mode 'sparse') and disp_pair_cap (disp_pairs: a dispersion list
    of its own), each None where it does not apply."""
    skin = config.nlist_skin
    out = dict(pair_cap=max(int(margin * counts.pairs(config.cutoff_2b + skin)) + 16, 64))
    n_t, max_ct = counts.triplets(config.cutoff_3b + skin)
    out['trip_cap'] = max(int(margin * n_t) + 32, 128)
    f_k, f_kt = max(1.3, float(margin)), max(1.4, float(margin))
    k_max = min(max(int(np.ceil(f_k * counts.max_degree(config.cutoff_3b + skin))) + 2, 8),
                max(n_waters - 1, 1))
    out['nlist_k_max'] = k_max
    out['nlist_kt'] = min(int(np.ceil(f_kt * max_ct)) + 8, k_max * (k_max - 1) // 2)
    half = 0.5 * skin if config.compact_eval == 'rebuild' else 0.0
    out['pair_eval_cap'] = min(max(int(margin * counts.pairs(config.cutoff_2b + half)) + 16, 64),
                               out['pair_cap'])
    out['trip_eval_cap'] = min(max(int(margin * counts.triplets(config.cutoff_3b + half)[0])
                                   + 32, 128), out['trip_cap'])
    out['elec_pair_cap'] = out['disp_pair_cap'] = None
    if elec_mode == 'sparse' or disp_pairs:
        cap = max(int(margin * counts.pairs(config.cutoff + PAIR_MARGIN + skin)) + 16, 64)
        out['elec_pair_cap' if elec_mode == 'sparse' else 'disp_pair_cap'] = cap
    return out


def block_layout(system: System, pos, box, cutoff, margin, n_devices=None):
    """Block mode's layout from whole positions pos [N, 3] (a tensor on the
    potential's device): (the serpentine site sort, the tile-pair capacity
    from the active tile pairs at the sorted layout, the s3/s5 line
    capacity from the most live lines of one (row water, cluster) slab at
    the sites' positions with the M sites placed, at most the number of
    column tiles, and for a mesh of n_devices shards the local list
    capacity from the most active pairs of one shard's row slab, else
    None)."""
    o = oxygen_positions(system, pos)
    mol_perm = bs.molecule_sort_permutation(o.detach().cpu().numpy(), box)
    site_perm = (4 * mol_perm[:, None] + np.arange(4)[None, :]).reshape(-1)
    n_sites = 4 * system.n_waters
    n_tiles = bs.padded(n_sites) // bs.TILE
    perm = torch.as_tensor(site_perm, device=pos.device)
    # a list that holds every tile pair counts the active ones
    full = bs.active_tile_pairs(bs.pad_rows(pos[perm], bs.padded(n_sites)), n_sites, box,
                                cutoff, n_tiles * n_tiles)
    pos_v = bs.pad_rows(compute_virtual_sites(system, pos)[perm], bs.padded(n_sites))
    _, count = bs.line_slots(bs.live_lines(pos_v, n_sites, full, box, cutoff), full)
    cap_local = None
    if n_devices:
        from mbpol_openmm_plugin_tpu_torch.parallel.mesh import padded_for_mesh
        ntl = padded_for_mesh(n_sites, n_devices) // bs.TILE // n_devices
        valid = (full.meta & bs.VALID) > 0
        per_tile = torch.bincount(full.ti[valid].long(), minlength=ntl * n_devices)
        per_dev = per_tile[:ntl * n_devices].reshape(n_devices, ntl).sum(dim=1)
        cap_local = max(int(margin * int(torch.max(per_dev))) + 8, 16)
    return (site_perm, max(int(margin * int(full.n_act)) + 8, 16),
            min(max(int(margin * int(torch.max(count))) + 2, 8), n_tiles), cap_local)


def _over_rows(mesh, n_rows, device, fn):
    """fn(device, 0, n_rows) without a mesh; under one, the sum over its
    shards' slabs of fn(shard device, lo, hi), added on the lead device in
    shard order."""
    if mesh is None:
        return fn(device, 0, n_rows)
    from mbpol_openmm_plugin_tpu_torch.parallel import mesh as M
    return M.sum_to_lead(mesh, M.map_rows(mesh, n_rows, fn))


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
    return _clone(pot, changes, changes)


def _clone(pot: MBPol, config_changes, param_changes):
    """A new MBPol sharing pot's topology, device, list capacities, PME
    setup and block layout, with its config and electrostatics parameters
    replaced by the given fields (the per-site tables are rebuilt from the
    new parameters at first use, MBPol._site_tables)."""
    new = object.__new__(MBPol)
    new.__dict__.update(pot.__dict__)
    new.config = dataclasses.replace(pot.config, **config_changes)
    new.elec_params = dataclasses.replace(pot.elec_params, **param_changes)
    return new


def inherit_capacities(src: MBPol, dst: MBPol):
    """dst takes src's tuned list capacities, triplet-build shape and block
    layout (both over the same topology), as the JAX function of that name:
    the term-subset potentials of r-RESPA keep the parent's tune_capacities
    operating point instead of the analytic bounds. Returns dst."""
    for attr in ('pair_cap', 'trip_cap', 'pair_eval_cap', 'trip_eval_cap', 'nlist_k_max',
                 'nlist_kt', 'elec_pair_cap', 'disp_pair_cap', '_block_info'):
        if hasattr(src, attr):
            setattr(dst, attr, getattr(src, attr))
    return dst
