"""Simulation driver (port of mbpol_openmm_plugin_tpu/md/simulation.py).

Velocity Verlet (NVE), BAOAB Langevin or velocity Verlet with the Andersen
thermostat (NVT), either under OpenMM's adaptive Monte Carlo barostat
(NPT), and their r-RESPA forms; centre-of-mass motion removal,
minimization and checkpoints.

A chunk (one report interval) runs in groups, as in the JAX package: a
group is the fixed list interval k when k > 1, else barostat_interval under
a barostat, else the whole chunk. With k > 1 the lists are built at each
group's start; with 'auto' a group builds them at its start and rebuilds
when twice the max O displacement since the last build exceeds half the
skin; with 1 every evaluation builds its own. A barostat move follows every
group, a short last one included. The ASPC dipole history is seeded from a
converged evaluation at the chunk's start and carried across groups and
volume moves; with scf='keep' each step's SOR loop starts from the last
step's dipoles (scf_warm_start). Where the health check at the end of the
last chunk evaluated this very state (the same positions tensor, unchanged
since, the same box, the same potential), its converged dipoles are the
seed, so that a report edge holds one converged evaluation, not two; they
have the bits a fresh evaluation would give (kernels sum in a fixed
order).

The box is a host float64 triple in the state, an argument of every
evaluation. An MD step reads nothing on the host: the displacement trigger
is a flag on the device that selects between the lists built at the step's
positions and the carried ones (as the JAX package's lax.cond), the draws
are made before the step into its buffers, and CM removal follows it. On a
card such a step is replayed as one CUDA graph (`Simulation`'s docstring
says when). Host reads stay at the chunk's edges: the per-step energies
after the chunk, the health check, and per barostat move its two uniforms
and two energies; and in the SOR loop's stop test once per iteration
(scf='keep' on a SOR potential, and every converged evaluation). Under a
profiler (utils/tracing) the health check of a block-mode potential also
reads its evaluation's active tile-pair count. Random
numbers come from one torch.Generator on the potential's device, seeded by
`seed`; a checkpoint carries its state.

r-RESPA: respa_inner > 1 runs the one-body term at dt / respa_inner inside
an outer step dt of the other terms (velocity Verlet or BAOAB Langevin);
respa_mid > 1 adds a middle rung at dt / respa_mid and leaves the terms of
respa_slow_terms (default the three-body) on the outer one (velocity
Verlet, optionally Andersen). The polarization sits on the middle rung, or
with respa_polarization_rung='inner' on the fast one beside the one-body
term. Each rung is an MBPol over its terms with the parent's capacities;
the pair and triplet lists are built once per rebuild through the
all-intermolecular potential and handed to every rung. The rungs' forces
are carried from step to step, across groups and report chunks, as the
dipole history is; they are evaluated afresh only where the positions or
the box changed outside the integrator (set_positions, a checkpoint
without them, minimization, an accepted barostat move). Unlike the JAX
package, which re-seeds them at every group and so breaks the splitting's
time symmetry once per group, a group boundary changes nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch.md import integrators as I
from mbpol_openmm_plugin_tpu_torch.md.minimize import lbfgs_minimize
from mbpol_openmm_plugin_tpu_torch.md.rpmd import mbpol_intra_inter_split, term_subset
from mbpol_openmm_plugin_tpu_torch.md.step_graph import LIST_KEYS, StepGraph
from mbpol_openmm_plugin_tpu_torch.models import electrostatics as elec
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, with_scf_method
from mbpol_openmm_plugin_tpu_torch.system import oxygen_positions
from mbpol_openmm_plugin_tpu_torch.utils import tracing, units
from mbpol_openmm_plugin_tpu_torch.utils.consts import device_const

RESPA_FORCES = ('slow', 'mid', 'fast')


def health_flag(diag):
    """Scalar bool tensor: SCF converged (or ASPC healthy) and no padded
    list overflowed."""
    ok = torch.ones((), dtype=torch.bool)
    reads = 0
    if 'converged' in diag:
        ok = diag['converged'].cpu() & ok
        reads += 1
    for k, v in diag.items():
        if k.endswith('_overflow'):
            ok = ok & ~torch.as_tensor(v).cpu()
            reads += 1
    tracing.count('host_reads', reads)
    return ok


def md_step_sources(state, nlists, run, draws):
    """{buffer name: the tensor it is loaded from (or shaped like)} of one
    `Simulation` step: positions, velocities, forces, pe, ke, ovf (the
    chunk's overflow flag); mu (the dipole history, with a warm start); the
    lists pairs/pmask/trips/tmask (with prebuilt lists); nl_pos, nl_ovf and
    rebuilds (the 'auto' carry: build positions, its overflow flag, the
    trigger count); noise or uniforms/normals (the thermostat's draws)."""
    src = dict(positions=state.positions, velocities=state.velocities,
               forces=state.forces, pe=state.potential_energy,
               ke=state.potential_energy, ovf=run['ovf'])
    if run['mu'] is not None:
        src['mu'] = run['mu']
    lists = run['nl'][0] if run['nl'] is not None else nlists
    if lists is not None:
        src.update(zip(LIST_KEYS, (lists[0][0], lists[0][1], lists[1][0], lists[1][1])))
    if run['nl'] is not None:
        src.update(nl_pos=run['nl'][1], nl_ovf=run['nl'][2], rebuilds=run['rebuilds'])
    src.update(draws)
    return src


@dataclasses.dataclass
class SimulationConfig:
    """The JAX package's SimulationConfig fields that the port runs, with
    the same defaults."""
    dt: float = 0.0002                   # ps
    temperature: Optional[float] = None  # K; None = NVE
    thermostat: str = 'andersen'         # 'andersen' | 'langevin' | 'none'
    collision_frequency: float = 50.0    # 1/ps (Andersen)
    friction: float = 1.0                # 1/ps (Langevin)
    barostat_pressure: Optional[float] = None   # bar; None = no barostat (needs temperature)
    barostat_interval: int = 25
    # seed each step's dipoles from the last step's (the ASPC history or
    # the SOR loop's start); False makes every evaluation a cold one
    scf_warm_start: bool = True
    # 'auto': a SOR potential runs its trajectory under the ASPC closure
    # (with_scf_method), single points stay converged; 'keep': the
    # potential's own closure along the trajectory
    scf: str = 'auto'
    # k >= 1: lists built every k steps (1: inside every evaluation; k > 1
    # needs a skin covering k steps of drift); 'auto': displacement
    # trigger (needs nlist_skin > 0)
    nlist_rebuild_interval: object = 1
    # remove the centre-of-mass velocity every k steps (0: never)
    cm_motion_interval: int = 0
    # r-RESPA: the fast (one-body) rung at dt / respa_inner (1: single time
    # step); respa_mid > 1: a middle rung at dt / respa_mid with the terms
    # not in respa_slow_terms, the fast rung at dt / (respa_mid respa_inner)
    respa_inner: int = 1
    respa_mid: int = 1
    respa_slow_terms: tuple = ('three_body',)
    # the rung of the polarization under respa_mid > 1: 'mid' or 'inner'
    # (beside the one-body term, so the ASPC closure advances every base step)
    respa_polarization_rung: str = 'mid'


class Simulation:
    """MD driver over an MBPol potential.

    Every MD step runs one body (`_body`) on the static buffers of a
    `StepGraph` (md/step_graph.py). `captured` is True, and each step at a
    box is one replay of a CUDA graph of that body, when the potential's
    device is a card and the step reads nothing on the host: no r-RESPA,
    and the trajectory's closure is ASPC with a warm start (scf='auto' on a
    SOR or ASPC potential with scf_warm_start) or there is no
    electrostatics term, and the potential's mesh, if any, keeps every shard
    on its device. r-RESPA, scf='keep' on a SOR potential, a DIIS
    potential, a mesh over several cards (a graph is captured on one
    device), cold evaluations and the CPU run the same body eagerly (every
    SOR or DIIS iteration reads its stop test on the host); so do the converged
    evaluations (the chunk's seed, the health check, the barostat's trial
    energies, minimization), but a chunk that starts from the state its
    last health check evaluated takes that evaluation's dipoles as its seed
    instead of evaluating again. The graph is captured at the first step at a
    box, after one eager step at it on a side stream, and again after an
    accepted barostat move. A failed capture or replay raises. `_eager=True`
    runs the body eagerly on a card too (for comparisons).
    """

    def __init__(self, potential: MBPol, config: Optional[SimulationConfig] = None, seed=0,
                 _eager=False):
        self.config = config if config is not None else SimulationConfig()
        cfg = self.config
        if cfg.scf not in ('auto', 'keep'):
            raise ValueError(f"SimulationConfig.scf must be 'auto' or 'keep', got {cfg.scf!r}")
        if cfg.thermostat not in ('andersen', 'langevin', 'none'):
            raise ValueError(f'unknown thermostat {cfg.thermostat!r}')
        if cfg.respa_polarization_rung not in ('mid', 'inner'):
            raise ValueError(f'unknown respa_polarization_rung {cfg.respa_polarization_rung!r}')
        if (int(cfg.respa_mid) > 1 and cfg.temperature is not None
                and cfg.thermostat == 'langevin'):
            raise ValueError('respa_mid > 1 supports velocity Verlet (+ Andersen) only; use the '
                             'two-level respa_inner split with langevin')
        if (cfg.scf == 'auto' and potential.elec_params is not None
                and potential.config.scf_method == 'sor'):
            # a mid-rung ASPC closure advances at the mid cadence, where a
            # deeper corrector keeps its dipole-lag drift down
            n_corr = (max(potential.config.aspc_n_corr, 2)
                      if int(cfg.respa_mid) > 1 and cfg.respa_polarization_rung == 'mid'
                      else None)
            potential = with_scf_method(potential, 'aspc', aspc_n_corr=n_corr)
        self.potential = potential
        self.system = potential.system
        self.generator = torch.Generator(device=potential.device)
        self.generator.manual_seed(int(seed))
        self.state: Optional[I.MDState] = None
        # adaptive barostat move size (scale nm^3, attempted, accepted),
        # carried across chunks, set from the first box
        self._baro = None
        self._split = None
        # RESPA force carry: dict(positions, box, slow, mid, fast), valid
        # while the state's positions are that tensor and the box is equal
        self._respa_f = None
        self._eager = bool(_eager)
        self._graph = None          # the StepGraph of the current box
        self.capture_ms = []        # host ms of each graph capture so far
        self._rebuilds = None       # 'auto' list rebuilds so far (device int)
        # the last health check's converged dipoles, keyed to what they were
        # computed from: ((positions tensor, its _version, box bytes,
        # potential), dipoles); the next chunk's seed, taken once
        self._kept_dipoles = None

    @property
    def _respa(self):
        cfg = self.config
        return int(cfg.respa_inner) > 1 or int(cfg.respa_mid) > 1

    @property
    def captured(self):
        """True when each MD step replays a CUDA graph (the rule in the
        class docstring)."""
        pot, cfg = self.potential, self.config
        closure_on_device = pot.elec_params is None or (
            cfg.scf_warm_start and pot.config.scf_method == 'aspc')
        return (pot.device.type == 'cuda' and not self._eager and not self._respa
                and not (pot.mesh is not None and pot.mesh.spans_devices)
                and closure_on_device)

    @property
    def list_rebuilds(self):
        """Displacement-triggered list rebuilds inside the steps so far
        ('auto'; the builds at each group's start are not counted)."""
        return 0 if self._rebuilds is None else int(self._rebuilds)

    # ------------------------------------------------------------------
    def _normal(self, shape):
        p = self.state.positions
        return torch.randn(shape, generator=self.generator, dtype=p.dtype, device=p.device)

    def _uniform(self, shape):
        p = self.state.positions
        return torch.rand(shape, generator=self.generator, dtype=p.dtype, device=p.device)

    @property
    def _barostat(self):
        cfg = self.config
        return (cfg.barostat_pressure is not None and cfg.temperature is not None
                and self.system.periodic)

    def set_positions(self, positions, box=None):
        """Start from `positions` (numpy or tensor; moved to the potential's
        device) at rest in `box` (default the system's), with a converged
        evaluation."""
        positions = self.potential.as_positions(positions)
        box = self.system.box if box is None else box
        box = None if box is None else np.array(box, np.float64)
        with tracing.phase('md.simulation.set_positions'):
            e, f, _, _ = self.potential.energy_forces(positions, box=box)
        self._kept_dipoles = None
        self.state = I.MDState(positions=positions, velocities=torch.zeros_like(positions),
                               forces=f, potential_energy=e, box=box, step=0)

    def set_velocities_to_temperature(self, temperature_k):
        """Maxwell-Boltzmann velocities at temperature_k from the generator."""
        normals = self._normal(tuple(self.state.positions.shape))
        v = I.maxwell_boltzmann_velocities(self.system, temperature_k, normals)
        self.state = dataclasses.replace(self.state, velocities=v)

    # ------------------------------------------------------------------
    def _auto_rebuild(self, nl_carry, p, box, pot):
        """The lists at p through pot where 2 * max O displacement since the
        last build exceeds skin / 2, else the carried ones: the
        counterpart of the JAX package's lax.cond, on the device. The lists
        are built every call and selected with the trigger, a 0-d bool on
        the device compared in float64 as the host compared float(2 disp)
        with 0.5 skin. nl_carry = (lists, build positions, overflow flag); a
        rebuild's overflow ORs into the flag. Under compact_eval='rebuild'
        the build compacts its lists to the eval capacities, as it did for
        the carried ones, so both sides of the select have one shape (the
        compaction runs in every step, not once per rebuild). Returns
        (nl_carry', trigger)."""
        ((pairs, pmask), (trips, tmask)), pb, ovf = nl_carry
        o_p, o_b = oxygen_positions(self.system, p), oxygen_positions(self.system, pb)
        disp = torch.max(torch.linalg.norm(o_p - o_b, dim=-1))
        fire = (2.0 * disp).to(torch.float64) > 0.5 * pot.config.nlist_skin
        ((pairs_n, pmask_n), (trips_n, tmask_n)), d = pot.build_neighbor_lists(p, box)
        ovf_n = ovf | d['pair_overflow'] | d['triplet_overflow']

        def sel(new, old):
            return torch.where(fire, new, old)
        return (((sel(pairs_n, pairs), sel(pmask_n, pmask)),
                 (sel(trips_n, trips), sel(tmask_n, tmask))),
                sel(p, pb), sel(ovf_n, ovf)), fire

    def _evaluate(self, pot, p, mu0, nlists, run, box, rebuild=False):
        """pot's evaluation at p with the run's current lists (rebuilt first
        when rebuild and the displacement trigger fires; run['rebuilds']
        counts the triggers); its overflow flags join the run's. Returns
        (E, F, diag)."""
        nl = nlists
        if run['nl'] is not None:
            if rebuild:
                run['nl'], fire = self._auto_rebuild(run['nl'], p, box, pot)
                run['rebuilds'] = run['rebuilds'] + fire
            nl = run['nl'][0]
        e, f, _, diag = pot._energy_forces_impl(p, mu0, nlists=nl, box=box)
        for k, v in diag.items():
            if k.endswith('_overflow'):
                run['ovf'] = run['ovf'] | v
        return e, f, diag

    @staticmethod
    def _predictor(run):
        """The dipole predictor (ASPC) or warm start from the run's history,
        None for cold evaluations."""
        mu = run['mu']
        if mu is None or run['B'] is None:
            return mu
        return torch.einsum('h,hnd->nd', run['B'], mu)

    @staticmethod
    def _push(run, mu_new):
        """Advance the run's dipole history with an evaluation's dipoles."""
        if run['mu'] is None or mu_new is None:
            return
        run['mu'] = mu_new if run['B'] is None else torch.cat([mu_new[None], run['mu'][:-1]])

    def _thermostat(self):
        cfg = self.config
        return cfg.thermostat if cfg.temperature is not None else 'none'

    def _draws(self):
        """One step's random draws, in the order the steps consume them:
        Langevin's normals ([respa_inner, natoms, 3] under RESPA), or
        Andersen's uniforms [natoms] then normals [natoms, 3]; nothing
        else draws inside a step, so drawing them before it gives the
        generator's sequence of the step-by-step loop."""
        shape = tuple(self.state.positions.shape)
        th, cfg = self._thermostat(), self.config
        if th == 'langevin':
            return dict(noise=self._normal(((int(cfg.respa_inner),) + shape) if self._respa
                                           else shape))
        if th == 'andersen':
            uniforms = self._uniform(shape[:1])
            return dict(uniforms=uniforms, normals=self._normal(shape))
        return {}

    def _after_step(self, state, draws):
        """Andersen collisions after an integrator step."""
        cfg = self.config
        if self._thermostat() == 'andersen':
            state = I.andersen_thermostat(self.system, state, cfg.dt, cfg.temperature,
                                          cfg.collision_frequency, draws['uniforms'],
                                          draws['normals'])
        return state

    def _cm_due(self, step):
        k = int(self.config.cm_motion_interval)
        return bool(k) and step % k == 0

    def _one_step(self, state, nlists, run, draws):
        """One integrator step (+ thermostat; CM removal is the caller's).
        run: the chunk's mutable carry ('nl': auto-rebuild carry or None,
        'ovf': overflow flag, 'mu': dipole history or None, 'B': ASPC
        predictor coefficients or None, 'rebuilds': trigger count);
        draws: `_draws()`."""
        cfg, pot = self.config, self.potential
        box = state.box
        mu0 = self._predictor(run)
        out = {}

        def ef(p):
            e, f, diag = self._evaluate(pot, p, mu0, nlists, run, box, rebuild=True)
            out['mu'] = diag.get('induced_dipoles')
            return e, f

        if self._thermostat() == 'langevin':
            state = I.langevin_step(self.system, ef, state, cfg.dt, cfg.temperature,
                                    cfg.friction, draws['noise'])
        else:
            state = I.velocity_verlet_step(self.system, ef, state, cfg.dt)
        self._push(run, out['mu'])
        return self._after_step(state, draws)

    def _body(self, g):
        """One MD step on the static buffers of g (a `StepGraph`): the
        integrator step with its evaluation (and on 'auto' the list
        select), the thermostat, the ASPC push and the kinetic energy,
        written back into the buffers in place. On a card this is what the
        graph holds; everywhere else it runs as it stands. It reads no
        device value on the host and copies nothing from it."""
        b = g.buffers
        state = I.MDState(positions=b['positions'], velocities=b['velocities'],
                          forces=b['forces'], potential_energy=b['pe'], box=g.box)
        nl = g.lists()
        run = dict(nl=None if 'nl_pos' not in b else (nl, b['nl_pos'], b['nl_ovf']),
                   ovf=b['ovf'], mu=b.get('mu'), B=g.B, rebuilds=b.get('rebuilds'))
        state = self._one_step(state, None if 'nl_pos' in b else nl, run,
                               {k: b[k] for k in ('noise', 'uniforms', 'normals') if k in b})
        b['positions'].copy_(state.positions)
        b['velocities'].copy_(state.velocities)
        b['forces'].copy_(state.forces)
        b['pe'].copy_(state.potential_energy)
        b['ke'].copy_(I.kinetic_energy(self.system, state.velocities))
        b['ovf'].copy_(run['ovf'])
        if 'mu' in b:
            b['mu'].copy_(run['mu'])
        if 'nl_pos' in b:
            ((pairs, pmask), (trips, tmask)), pos, ovf = run['nl']
            for k, v in zip(('pairs', 'pmask', 'trips', 'tmask', 'nl_pos', 'nl_ovf'),
                            (pairs, pmask, trips, tmask, pos, ovf)):
                b[k].copy_(v)
            b['rebuilds'].copy_(run['rebuilds'])

    # ------------------------------------------------------------------
    def _respa_rungs(self):
        """The RESPA rungs, built once: dict(intra: the one-body ef, inter:
        the all-intermolecular MBPol that builds the shared lists, and for
        respa_mid > 1 mid, slow and, with the polarization on the inner
        rung, fast: MBPols over their terms with the parent's capacities)."""
        if self._split is None:
            cfg = self.config
            ef_intra, pot_inter = mbpol_intra_inter_split(self.potential)
            rungs = dict(intra=ef_intra, inter=pot_inter, slow=pot_inter, fast=None)
            if int(cfg.respa_mid) > 1:
                inter_terms = pot_inter.config.terms
                slow = tuple(t for t in inter_terms if t in cfg.respa_slow_terms)
                mid = tuple(t for t in inter_terms if t not in slow)
                if cfg.respa_polarization_rung == 'inner' and 'electrostatics' in mid:
                    mid = tuple(t for t in mid if t != 'electrostatics')
                    rungs['fast'] = term_subset(self.potential, ('one_body', 'electrostatics'))
                if not slow or not mid:
                    raise ValueError(f'respa_mid > 1 needs a non-trivial term split; got '
                                     f'slow={slow} mid={mid} from respa_slow_terms='
                                     f'{cfg.respa_slow_terms}')
                rungs['mid'] = term_subset(self.potential, mid)
                rungs['slow'] = term_subset(self.potential, slow)
            self._split = rungs
        return self._split

    def _respa_seed(self, state, nlists, run):
        """The rungs' forces at the state's positions and box, where the
        carry is not valid: as the JAX package seeds a group, from the
        dipole predictor of the run's history, which the seed does not
        advance."""
        rungs, box = self._respa_rungs(), state.box
        mu_seed = self._predictor(run)
        mid = int(self.config.respa_mid) > 1
        f = dict(positions=state.positions, box=box, mid=None)
        if mid:
            polar_mid = rungs['fast'] is None
            f['mid'] = self._evaluate(rungs['mid'], state.positions,
                                      mu_seed if polar_mid else None, nlists, run, box)[1]
            f['slow'] = self._evaluate(rungs['slow'], state.positions, None, nlists, run, box)[1]
            if not polar_mid:
                f['fast'] = self._evaluate(rungs['fast'], state.positions, mu_seed, nlists,
                                           run, box)[1]
                return f
        else:
            f['slow'] = self._evaluate(rungs['slow'], state.positions, mu_seed, nlists, run,
                                       box)[1]
        f['fast'] = rungs['intra'](state.positions, box)[1]
        return f

    def _respa_carry_valid(self, state):
        f = self._respa_f
        return (f is not None and f['positions'] is state.positions
                and np.array_equal(np.asarray(f['box']), np.asarray(state.box)))

    def _one_step_respa(self, state, nlists, run, draws):
        """One r-RESPA outer step on the carried rung forces
        (self._respa_f, valid at state.positions)."""
        cfg = self.config
        rungs, box, fc = self._respa_rungs(), state.box, self._respa_f
        three = int(cfg.respa_mid) > 1
        polar_inner = rungs['fast'] is not None

        def ef_fast(p):
            if not polar_inner:
                return rungs['intra'](p, box)
            e, f, diag = self._evaluate(rungs['fast'], p, self._predictor(run), nlists, run, box)
            self._push(run, diag.get('induced_dipoles'))
            return e, f

        def ef_mid(p):
            e, f, diag = self._evaluate(rungs['mid'], p,
                                        None if polar_inner else self._predictor(run),
                                        nlists, run, box, rebuild=True)
            if not polar_inner:
                self._push(run, diag.get('induced_dipoles'))
            return e, f

        def ef_slow(p):
            # two-level: the polarization's rung, which rebuilds the lists;
            # three-level: at the last mid evaluation's positions
            e, f, diag = self._evaluate(rungs['slow'], p,
                                        None if three else self._predictor(run),
                                        nlists, run, box, rebuild=not three)
            if not three:
                self._push(run, diag.get('induced_dipoles'))
            return e, f

        # a stateful fast rung is never re-evaluated at a step's start
        assert fc['fast'] is not None, 'RESPA fast forces must be carried'
        if three:
            state, f_mid, f_slow, f_fast = I.respa3_velocity_verlet_step(
                self.system, ef_fast, ef_mid, ef_slow, state, fc['mid'], fc['slow'], cfg.dt,
                int(cfg.respa_mid), int(cfg.respa_inner), f_fast=fc['fast'])
        elif self._thermostat() == 'langevin':
            n = int(cfg.respa_inner)
            state, f_slow, f_fast = I.respa_langevin_step(
                self.system, ef_fast, ef_slow, state, fc['slow'], cfg.dt, n, cfg.temperature,
                cfg.friction, draws['noise'], f_fast=fc['fast'])
            f_mid = None
        else:
            state, f_slow, f_fast = I.respa_velocity_verlet_step(
                self.system, ef_fast, ef_slow, state, fc['slow'], cfg.dt,
                int(cfg.respa_inner), f_fast=fc['fast'])
            f_mid = None
        self._respa_f = dict(positions=state.positions, box=box, slow=f_slow, mid=f_mid,
                             fast=f_fast)
        return self._after_step(state, draws)

    def _energy_at(self, run):
        """The barostat's converged evaluation (positions, box) -> (E, F);
        its overflow flags join the chunk's."""
        def energy_at(p, box):
            with tracing.span('md.simulation.barostat_trial'):
                e, f, _, diag = self.potential._energy_forces_impl(p, box=box)
            for k, v in diag.items():
                if k.endswith('_overflow'):
                    run['ovf'] = run['ovf'] | v
            return e, f
        return energy_at

    def _chunk(self, state, n_steps):
        """n_steps steps in groups, a barostat move after each. Returns
        (state, per-step PE [n], per-step KE [n], overflow flag, (moves
        attempted, accepted))."""
        pot, cfg = self.potential, self.config
        use_nl = pot.use_neighbor_lists
        auto_nl = use_nl and cfg.nlist_rebuild_interval == 'auto'
        if auto_nl and not pot.config.nlist_skin > 0:
            raise ValueError("nlist_rebuild_interval='auto' requires nlist_skin > 0")
        reuse = (1 if cfg.nlist_rebuild_interval == 'auto'
                 else max(int(cfg.nlist_rebuild_interval), 1))
        warm = cfg.scf_warm_start and pot.elec_params is not None
        aspc = warm and pot.config.scf_method == 'aspc'
        dev = state.positions.device
        B = (device_const(elec.aspc_predictor_coefficients(pot.config.aspc_k),
                          dtype=state.positions.dtype, device=dev) if aspc else None)
        mu = None
        if warm:
            # seed the dipoles from a converged evaluation at the chunk's
            # start: the last health check's where it evaluated this state
            with tracing.span('md.simulation.dipole_seed'):
                mu = self._take_kept_dipoles(state, pot)
                tracing.count('dipole_seeds')
                if mu is None:
                    mu = pot._energy_forces_impl(state.positions,
                                                 box=state.box)[3]['induced_dipoles']
                else:
                    tracing.count('dipole_seed_reuses')
            if aspc:
                mu = mu[None].repeat(len(B), 1, 1)
        respa = self._respa
        pot_nl = self._respa_rungs()['inter'] if respa else pot

        baro = self._barostat
        group = reuse if reuse > 1 else (cfg.barostat_interval if baro else n_steps)
        if baro:
            group = min(group, cfg.barostat_interval)
        run = dict(nl=None, ovf=torch.zeros((), dtype=torch.bool, device=dev), mu=mu, B=B,
                   rebuilds=torch.zeros((), dtype=torch.int64, device=dev) if auto_nl else None)
        pes, kes = [], []
        moves = [0, 0]
        done = 0
        while done < n_steps:
            n = min(group, n_steps - done)
            nlists = None
            if use_nl and (auto_nl or reuse > 1):
                with tracing.span('md.simulation.group_lists'):
                    (pl, tl), d = pot_nl.build_neighbor_lists(state.positions, state.box)
                tracing.count('list_builds')
                run['ovf'] = run['ovf'] | d['pair_overflow'] | d['triplet_overflow']
                if auto_nl:
                    run['nl'] = ((pl, tl), state.positions, run['ovf'])
                else:
                    nlists = (pl, tl)
            if respa:
                if not self._respa_carry_valid(state):
                    self._respa_f = self._respa_seed(state, nlists, run)
                pe, ke = [], []
                for _ in range(n):
                    state = self._one_step_respa(state, nlists, run, self._draws())
                    if self._cm_due(state.step):
                        state = dataclasses.replace(state, velocities=I.remove_cm_motion(
                            self.system, state.velocities))
                    pe.append(state.potential_energy)
                    ke.append(I.kinetic_energy(self.system, state.velocities))
                pe, ke = torch.stack(pe), torch.stack(ke)
            else:
                state, pe, ke = self._group(state, nlists, run, n)
            pes.append(pe)
            kes.append(ke)
            if run['nl'] is not None:
                run['ovf'] = run['ovf'] | run['nl'][2]
                run['nl'] = None
            if baro:
                with tracing.span('md.simulation.barostat_move'):
                    state, self._baro, accepted = I.monte_carlo_barostat_move_adaptive(
                        self.system, self._energy_at(run), state, cfg.temperature,
                        cfg.barostat_pressure, self._baro, self._uniform((2,)))
                moves[0] += 1
                moves[1] += int(accepted)
            done += n
        if run['rebuilds'] is not None:
            self._rebuilds = (run['rebuilds'] if self._rebuilds is None
                              else self._rebuilds + run['rebuilds'])
        return state, torch.cat(pes), torch.cat(kes), run['ovf'], tuple(moves)

    @staticmethod
    def _dipole_key(state, pot):
        box = None if state.box is None else np.asarray(state.box, np.float64).tobytes()
        return state.positions, state.positions._version, box, pot

    def _take_kept_dipoles(self, state, pot):
        """The last health check's converged dipoles if it evaluated this
        state through pot: the same positions tensor (`is`), not written
        since (its `_version`), the same box bits. Else None. Either way
        they are dropped: a seed is taken once."""
        kept, self._kept_dipoles = self._kept_dipoles, None
        if kept is None:
            return None
        (p, version, box, kpot), mu = kept
        q, q_version, q_box, _ = self._dipole_key(state, pot)
        return mu if p is q and version == q_version and box == q_box and kpot is pot else None

    def _group(self, state, nlists, run, n):
        """n steps of a group through `_body` on the static buffers of a
        StepGraph (replayed as a graph where `captured` says so), CM
        removal on the steps it falls on. Returns (state, PE [n], KE [n])
        and updates run's carry."""
        with tracing.span('md.step_graph.group'):
            draws = self._draws()
            src = md_step_sources(state, nlists, run, draws)
            g = self._graph
            if g is None or not g.matches(self.potential, state.box, run['B'], src):
                # a new box (an accepted barostat move) or new capacities: the
                # old graph and its memory go, the next step captures anew
                self._graph = g = None
                g = self._graph = StepGraph(self.potential, state.box, run['B'], src,
                                            self.captured, self.capture_ms)
            g.load(src)
            b = g.buffers
            pe = torch.empty((n,), dtype=b['pe'].dtype, device=b['pe'].device)
            ke = torch.empty_like(pe)
            for i in range(n):
                if i:
                    g.load(self._draws())
                g.step(self._body)
                if self._cm_due(state.step + i + 1):
                    v = I.remove_cm_motion(self.system, b['velocities'])
                    b['velocities'].copy_(v)
                    b['ke'].copy_(I.kinetic_energy(self.system, v))
                pe[i].copy_(b['pe'])
                ke[i].copy_(b['ke'])
            out = g.unload(skip=('ke', 'noise', 'uniforms', 'normals'))
            run['ovf'] = out['ovf']
            if 'mu' in out:
                run['mu'] = out['mu']
            if 'nl_pos' in out:
                run['nl'] = (((out['pairs'], out['pmask']), (out['trips'], out['tmask'])),
                             out['nl_pos'], out['nl_ovf'])
                run['rebuilds'] = out['rebuilds']
            positions, velocities, forces, e = (out['positions'], out['velocities'],
                                                out['forces'], out['pe'])
            state = dataclasses.replace(state, positions=positions, velocities=velocities,
                                        forces=forces, potential_energy=e, step=state.step + n)
            return state, pe, ke

    def step(self, n_steps, report_interval=None, check_health=True):
        """Advance n_steps. Returns per-report-interval metrics (potential,
        kinetic and total energy in kJ/mol, temperature in K), per-step
        `step_total_energy` [n_steps + 1] (before the first step and after
        each) and `step_temperature` [n_steps] (after each), and the
        barostat moves attempted and accepted in this call.

        With check_health=True, raises RuntimeError at a report boundary if
        the energy went NaN, a list, tile-pair, line or pair list overflowed
        during the chunk (a barostat trial included), or a converged
        diagnostic evaluation of the current positions and box fails its SCF
        or overflows."""
        report_interval = report_interval or n_steps
        if self._barostat and self._baro is None:
            self._baro = I.barostat_scale_init(self.state.box)
        pes, kes, steps = [], [], []
        with tracing.span('md.simulation.readback'):
            e_steps = [float(self.state.potential_energy)
                       + float(I.kinetic_energy(self.system, self.state.velocities))]
            tracing.count('host_reads', 2)
        ke_steps = []
        moves = np.zeros(2, np.int64)
        remaining = n_steps
        while remaining > 0:
            with tracing.span('md.simulation.chunk'):
                chunk = min(report_interval, remaining)
                self.state, pe, ke, ovf, chunk_moves = self._chunk(self.state, chunk)
                moves += chunk_moves
                with tracing.span('md.simulation.readback'):
                    pe_host, ke_host = pe.cpu().numpy(), ke.cpu().numpy()
                    tracing.count('host_reads', 2)
                e_steps.extend(pe_host + ke_host)
                ke_steps.extend(ke_host)
                with tracing.span('md.simulation.health_check'):
                    if check_health:
                        self._check_health(ovf, pe_host, chunk)
                    kes.append(float(I.kinetic_energy(self.system, self.state.velocities)))
                    tracing.count('host_reads')
                pes.append(float(pe_host[-1]))
                steps.append(self.state.step)
                remaining -= chunk
        ndof = 3 * int(np.sum(np.asarray(self.system.masses) > 0))
        to_t = 2.0 / (ndof * units.BOLTZMANN_KJ_MOL_K)
        pes = np.asarray(pes)
        kes = np.asarray(kes)
        return dict(step=np.asarray(steps), potential_energy=pes, kinetic_energy=kes,
                    total_energy=pes + kes, temperature=to_t * kes,
                    step_total_energy=np.asarray(e_steps),
                    step_temperature=to_t * np.asarray(ke_steps),
                    barostat_attempted=int(moves[0]), barostat_accepted=int(moves[1]))

    def _check_health(self, ovf, pe_host, chunk):
        """Raise RuntimeError if the chunk's overflow flag is set, its
        energies went NaN, or a converged evaluation at the current
        positions and box fails its SCF or overflows."""
        tracing.count('host_reads')
        if bool(ovf):
            raise RuntimeError(
                f'list or tile-pair overflow during the chunk ending at step '
                f'{self.state.step}: raise the capacities (tune_capacities)')
        key = self._dipole_key(self.state, self.potential)
        diag = self.potential._energy_forces_impl(self.state.positions, box=self.state.box)[3]
        nan = np.isnan(pe_host)
        if nan.any() or not bool(health_flag(diag)):
            at = self.state.step - chunk + int(np.argmax(nan)) if nan.any() else self.state.step
            raise RuntimeError(
                'simulation health check failed at step %d: %s' %
                (at, {k: v for k, v in diag.items()
                      if k in ('converged', 'iterations', 'epsilon')
                      or k.endswith('_overflow')}))
        if tracing.enabled() and 'elec_tile_pairs' in diag:
            # block mode, traced only: the active tile pairs of this state
            tracing.count('elec_tile_pairs', int(diag['elec_tile_pairs']))
            tracing.count('elec_tile_reads')
            tracing.count('host_reads')
        mu = diag.get('induced_dipoles')
        self._kept_dipoles = None if mu is None else (key, mu.detach())

    # ------------------------------------------------------------------
    def minimize_energy(self, max_iterations=200, tolerance=10.0, method='lbfgs'):
        """Local energy minimization in the state's box (OpenMM
        LocalEnergyMinimizer: L-BFGS, tolerance = RMS force in kJ/mol/nm,
        md/minimize.py); method='descent' is the JAX package's backtracking
        steepest descent. Every evaluation is a converged one. Returns the
        minimizer's diagnostics (iterations; for L-BFGS also grad_rms,
        converged and the energy after each iteration)."""
        if self.state is None:
            raise RuntimeError('call set_positions first')
        pot, box = self.potential, self.state.box

        def ef(p):
            e, f, _, _ = pot._energy_forces_impl(p, box=box)
            return e, f

        def energy_grad(p):
            e, f = ef(p)
            return e, -f

        pos = self.state.positions
        if method == 'lbfgs':
            pos, _, diag = lbfgs_minimize(energy_grad, pos, max_iterations=max_iterations,
                                          tolerance=tolerance)
        elif method == 'descent':
            step_size, it = 0.01, 0
            while it < max_iterations and step_size > 1e-10:
                e0, f = ef(pos)
                trial = pos + step_size / (float(torch.max(torch.abs(f))) + 1e-30) * f
                e1, _ = ef(trial)
                if float(e1) < float(e0):
                    pos, step_size = trial, step_size * 1.2
                else:
                    step_size *= 0.5
                it += 1
            diag = dict(iterations=it)
        else:
            raise ValueError(f"method must be 'lbfgs' or 'descent', got {method!r}")
        e, f, _, _ = pot.energy_forces(pos, box=box)
        self.state = dataclasses.replace(self.state, positions=pos, forces=f,
                                         potential_energy=e)
        self._kept_dipoles = None
        return diag

    # ------------------------------------------------------------------
    def checkpoint(self):
        """The dynamic state as numpy arrays: positions, velocities, forces,
        energy, box, step, the generator's state, the adaptive barostat's
        (scale, attempted, accepted) and the RESPA rungs' carried forces, so
        that a resumed run is bit-identical to an uninterrupted one with the
        same report boundaries."""
        s = self.state
        ck = dict(positions=s.positions.cpu().numpy(), velocities=s.velocities.cpu().numpy(),
                  forces=s.forces.cpu().numpy(),
                  potential_energy=s.potential_energy.cpu().numpy(),
                  step=np.asarray(s.step), rng=self.generator.get_state().numpy())
        if s.box is not None:
            ck['box'] = np.asarray(s.box, np.float64)
        if self._baro is not None:
            ck['baro_scale'] = np.asarray(self._baro[0], np.float64)
            ck['baro_attempted'] = np.asarray(self._baro[1])
            ck['baro_accepted'] = np.asarray(self._baro[2])
        if self._respa_carry_valid(s):
            for k in RESPA_FORCES:
                if self._respa_f[k] is not None:
                    ck['respa_' + k] = self._respa_f[k].cpu().numpy()
        return ck

    def load_checkpoint(self, ck):
        pot = self.potential

        def tensor(a):
            return torch.as_tensor(np.asarray(a), dtype=pot.dtype, device=pot.device)

        self.state = I.MDState(
            positions=tensor(ck['positions']), velocities=tensor(ck['velocities']),
            forces=tensor(ck['forces']), potential_energy=tensor(ck['potential_energy']),
            box=np.array(ck['box'], np.float64) if 'box' in ck else None,
            step=int(ck['step']))
        self.generator.set_state(torch.as_tensor(np.asarray(ck['rng']), dtype=torch.uint8))
        self._kept_dipoles = None
        if 'baro_scale' in ck:
            self._baro = (float(ck['baro_scale']), int(ck['baro_attempted']),
                          int(ck['baro_accepted']))
        self._respa_f = None
        if 'respa_slow' in ck:
            self._respa_f = dict(positions=self.state.positions, box=self.state.box,
                                 **{k: tensor(ck['respa_' + k]) if 'respa_' + k in ck else None
                                    for k in RESPA_FORCES})

    def save_checkpoint(self, path):
        np.savez(path, **self.checkpoint())

    def load_checkpoint_file(self, path):
        with np.load(path) as z:
            self.load_checkpoint({k: z[k] for k in z.files})
