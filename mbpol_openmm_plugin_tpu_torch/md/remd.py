"""Temperature replica-exchange MD, parallel tempering (port of
mbpol_openmm_plugin_tpu/md/remd.py).

Each replica runs BAOAB Langevin at its ladder temperature; every
`exchange_interval` steps one even/odd-alternating Metropolis sweep (Sugita
& Okamoto, Chem. Phys. Lett. 314, 141 (1999)) swaps neighbouring
configurations with P_acc = min(1, exp[(beta_i - beta_j)(U_i - U_j)]), and
the configuration arriving at slot i has its velocities scaled by
sqrt(T_i / T_j). The thermostat's noise belongs to the ladder slot, not to
the configuration.

Where the JAX package vmaps the potential over the replica axis, the port
evaluates the replicas one after another; with a device mesh (`mesh`) the
ladder's slots sit on its shards in contiguous blocks, each slot's
evaluation on its shard's device through a copy of the potential made once
per device, its results gathered on the potential's device. The default closure of a REMD
potential is SOR with each replica's last dipoles as the start of its next
loop (scf_warm_start), whose stop test reads the host once per iteration,
so the ladder runs eagerly on a card. The draws (each step's normals
[R, natoms, 3], each sweep's uniforms [R]) come from one torch.Generator
before they are used.

Units: nm, ps, amu, kJ/mol.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch.md import integrators as I
from mbpol_openmm_plugin_tpu_torch.md.simulation import health_flag
from mbpol_openmm_plugin_tpu_torch.parallel.mesh import Mesh, shard_of, to_device
from mbpol_openmm_plugin_tpu_torch.system import System, compute_virtual_sites
from mbpol_openmm_plugin_tpu_torch.utils import units


def geometric_ladder(t_min, t_max, n_replicas):
    """T_r = T_min (T_max/T_min)^(r/(R-1)): a constant beta ratio, roughly
    uniform neighbour acceptance when the heat capacity is flat."""
    return np.geomspace(float(t_min), float(t_max), int(n_replicas))


def round_trip_stats(walkers):
    """Replica-flow diagnostics from the per-block walker array [n_blocks,
    R] (the walker id in each ladder slot): round_trips_total (bottom slot
    -> top slot -> bottom, summed over walkers), blocks_per_round_trip
    (n_blocks R / trips, None without a trip) and slot_flow (mean |slot
    change| per walker per block)."""
    w = np.asarray(walkers)
    n_blocks, R = w.shape
    slot_of = np.empty_like(w)
    slot_of[np.arange(n_blocks)[:, None], w] = np.arange(R)[None, :]
    trips = 0
    # per walker: -1 not yet at the bottom, 0 needs the top, 1 needs the bottom
    phase = np.where(slot_of[0] == 0, 0, -1)
    for b in range(1, n_blocks):
        s = slot_of[b]
        phase = np.where((phase == -1) & (s == 0), 0, phase)
        phase = np.where((phase == 0) & (s == R - 1), 1, phase)
        done = (phase == 1) & (s == 0)
        trips += int(done.sum())
        phase = np.where(done, 0, phase)
    flow = float(np.abs(np.diff(slot_of, axis=0)).mean()) if n_blocks > 1 else 0.0
    return dict(round_trips_total=int(trips),
                blocks_per_round_trip=None if trips == 0 else round(n_blocks * R / trips, 1),
                slot_flow=round(flow, 4))


def exchange_permutation(potential_energies, temperatures, uniforms, parity):
    """One Metropolis sweep over the neighbour pairs (r, r+1) with
    r % 2 == parity. uniforms: [R] draws in [0, 1). Returns (perm [R]: the
    involution slot -> the slot whose configuration it receives, accept [R]:
    True on the left member of each accepted pair)."""
    pe = potential_energies
    T = torch.as_tensor(np.asarray(temperatures, np.float64), dtype=pe.dtype, device=pe.device)
    betas = 1.0 / (units.BOLTZMANN_KJ_MOL_K * T)
    R = pe.shape[0]
    i = torch.arange(R, device=pe.device)
    j = torch.clamp(i + 1, max=R - 1)
    candidate = ((i % 2) == int(parity)) & (i + 1 < R)
    log_ratio = (betas - betas[j]) * (pe - pe[j])
    accept = candidate & (torch.log(uniforms) < log_ratio)
    swap_down = torch.roll(accept, 1) & (i > 0)
    perm = torch.where(accept, i + 1, torch.where(swap_down, i - 1, i))
    return perm, accept


def apply_exchange(state: I.MDState, perm, temperatures):
    """The replica-batched state permuted by `perm` (slot -> source slot),
    the incoming velocities scaled by sqrt(T_slot / T_source)."""
    p = state.positions
    T = torch.as_tensor(np.asarray(temperatures, np.float64), dtype=p.dtype, device=p.device)
    vscale = torch.sqrt(T / T[perm])[:, None, None]
    return dataclasses.replace(state, positions=p[perm],
                               velocities=state.velocities[perm] * vscale,
                               forces=state.forces[perm],
                               potential_energy=state.potential_energy[perm])


def initial_state(system: System, positions, temperatures, box=None):
    """Replica-batched MDState ([R, natoms, 3]) from one configuration
    [natoms, 3] (tiled) or a per-replica stack [R, natoms, 3]; zero
    velocities, forces and energies (filled by the caller)."""
    R = len(np.asarray(temperatures))
    pos = positions
    if pos.ndim == 2:
        pos = pos[None].repeat(R, 1, 1)
    if pos.shape[0] != R:
        raise ValueError(f'positions leading dim {pos.shape[0]} != n_replicas {R}')
    box = system.box if box is None else box
    return I.MDState(positions=pos, velocities=torch.zeros_like(pos),
                     forces=torch.zeros_like(pos),
                     potential_energy=torch.zeros((R,), dtype=pos.dtype, device=pos.device),
                     box=None if box is None else np.array(box, np.float64), step=0)


def make_remd_block(system: System, ef_fn, temperatures, dt, friction=1.0,
                    exchange_interval=25, list_builder=None):
    """The REMD block
        block(state, mu, walker, parity, normal, uniform)
          -> (state, mu, walker, stats)
    runs `exchange_interval` BAOAB Langevin steps (each replica at its
    ladder temperature), then one exchange sweep.

    ef_fn(positions [natoms, 3], mu[, nlists], box) -> (E, F, mu_new, ok):
    one replica's evaluation, or a sequence of R of them, one per ladder
    slot; mu is an opaque per-replica SCF carry (a list of R entries, None
    entries to disable it). walker: [R] walker ids riding
    the configurations. normal(shape) / uniform(shape) give the step's
    normals [R, natoms, 3] and the sweep's uniforms [R].

    list_builder(positions [natoms, 3], box) -> (nlists, overflow): the
    padded pair and triplet lists of one replica, built once per block and
    reused for its steps (exact while the skin covers one block's drift);
    stats['list_overflow'] is their overflow flag. stats['pe'] holds the
    per-step energies [k, R], stats['accept'] the sweep's [R]."""
    T = np.asarray(temperatures, np.float64)
    efs = list(ef_fn) if isinstance(ef_fn, (list, tuple)) else [ef_fn] * len(T)

    def block(state, mu, walker, parity, normal, uniform):
        R, box = len(T), state.box
        nl, ovf = [None] * R, torch.zeros((), dtype=torch.bool, device=state.positions.device)
        if list_builder is not None:
            built = [list_builder(p, box) for p in state.positions]
            nl = [b[0] for b in built]
            for b in built:
                ovf = ovf | b[1]
        pes = []
        mu = list(mu)
        for _ in range(int(exchange_interval)):
            noise = normal(tuple(state.positions.shape))
            new = []
            for r in range(R):
                def ef(p, r=r):
                    args = (mu[r],) + ((nl[r],) if list_builder is not None else ()) + (box,)
                    e, f, mu[r], _ = efs[r](p, *args)
                    return e, f
                one = I.MDState(positions=state.positions[r], velocities=state.velocities[r],
                                forces=state.forces[r], potential_energy=state.potential_energy[r],
                                box=box)
                new.append(I.langevin_step(system, ef, one, dt, float(T[r]), friction, noise[r]))
            state = dataclasses.replace(
                state, positions=torch.stack([s.positions for s in new]),
                velocities=torch.stack([s.velocities for s in new]),
                forces=torch.stack([s.forces for s in new]),
                potential_energy=torch.stack([s.potential_energy for s in new]),
                step=state.step + 1)
            pes.append(state.potential_energy)
        perm, accept = exchange_permutation(state.potential_energy, T,
                                            uniform((R,)), parity)
        state = apply_exchange(state, perm, T)
        perm_h = perm.cpu().numpy()
        mu = [mu[k] for k in perm_h]
        return state, mu, np.asarray(walker)[perm_h], dict(pe=torch.stack(pes), accept=accept,
                                                          list_overflow=ovf)

    return block


@dataclasses.dataclass
class REMDConfig:
    dt: float = 0.0002              # ps
    friction: float = 1.0           # 1/ps (BAOAB Langevin)
    exchange_interval: int = 25     # MD steps between exchange sweeps
    scf_warm_start: bool = True     # each replica's SOR loop starts from its last dipoles
    # build the padded 2B pair / 3B triplet lists once per exchange block
    # (bulk systems; exact while nlist_skin covers one block's drift; an
    # overflow raises at the block's end)
    nlist_reuse: bool = False


def _replica_evaluation(potential, warm):
    """One replica's evaluation ef(p, mu, [nlists,] box) -> (E, F, the
    dipoles to carry, diag) on the potential's device, the results on p's;
    mu starts the SCF when `warm`. Built from the potential alone, so
    REMDSimulation's block function does not hold the driver in a
    reference cycle."""
    def ef(p, mu, *rest):
        dev = potential.device
        nl = to_device(rest[0], dev) if len(rest) == 2 else None
        e, f, _, diag = potential._energy_forces_impl(p.to(dev), to_device(mu, dev) if warm
                                                      else None, nlists=nl, box=rest[-1])
        mu_new = to_device(diag.get('induced_dipoles'), p.device) if warm else None
        return e.to(p.device), f.to(p.device), mu_new, diag

    return ef


class REMDSimulation:
    """Parallel tempering over an MBPol potential (an NVT ladder).

        remd = REMDSimulation(pot, temperatures=geometric_ladder(280, 420, 8))
        remd.set_positions(pos)
        remd.set_velocities_to_temperature()
        out = remd.run(n_blocks=100)   # 100 exchange sweeps
        out['potential_energy']        # [n_blocks, R] per-slot PE at block ends
        out['acceptance']              # [R-1] per neighbour pair
        out['walker']                  # [n_blocks, R] replica flow

    R = 1 is a valid ladder (no exchange candidates), the single-replica
    baseline of a ladder's efficiency.

    mesh: a parallel.mesh.Mesh to put the ladder's slots over (slot r on
    shard floor(r size / R)), each slot evaluated on its shard's device
    through the shard's copy of the potential (MBPol.to_device).
    The potential's own mesh is not inherited: pick one level, a meshed
    potential (few large replicas) or the slots over the shards (many small
    ones), as in the JAX package. The draws come from one generator on the
    potential's device, so the trajectory does not depend on the mesh."""

    def __init__(self, potential, temperatures, config: Optional[REMDConfig] = None,
                 seed: int = 0, mesh=None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f'mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}')
        self.mesh = mesh
        self.potential = potential
        self.system = potential.system
        self.temperatures = np.asarray(temperatures, float)
        if len(self.temperatures) < 1:
            raise ValueError('REMD needs at least 1 replica')
        if np.any(np.diff(self.temperatures) <= 0):
            raise ValueError('temperatures must be strictly increasing')
        self.config = config = config if config is not None else REMDConfig()
        self.generator = torch.Generator(device=potential.device)
        self.generator.manual_seed(int(seed))
        R = len(self.temperatures)
        self.walker = np.arange(R)
        self._parity = 0
        self.state: Optional[I.MDState] = None
        self._mu = None
        self._accept_sum = np.zeros(R, np.int64)
        self._exchange_attempts = np.zeros(R, np.int64)
        # an ASPC potential runs cold (converged) evaluations, as in the JAX
        # package: last-step dipoles are no ASPC predictor
        self._warm = (config.scf_warm_start and potential.elec_params is not None
                      and potential.config.scf_method != 'aspc')
        list_builder = None
        if config.nlist_reuse:
            if not potential.use_neighbor_lists:
                raise ValueError('nlist_reuse needs a neighbor-list potential (bulk systems)')
            if potential.config.nlist_skin <= 0:
                raise ValueError('nlist_reuse requires nlist_skin > 0 to stay exact across an '
                                 'exchange block')

            def list_builder(p, box):
                nl, d = potential.build_neighbor_lists(p, box)
                return nl, d['pair_overflow'] | d['triplet_overflow']

        if mesh is None:
            self._efs = [_replica_evaluation(potential, self._warm)] * R
        else:
            copies = [_replica_evaluation(potential.to_device(d), self._warm)
                      for d in mesh.devices]
            self._efs = [copies[shard_of(r, R, mesh)] for r in range(R)]
        self._block = make_remd_block(self.system, self._efs, self.temperatures, config.dt,
                                      friction=config.friction,
                                      exchange_interval=config.exchange_interval,
                                      list_builder=list_builder)

    def _normal(self, shape):
        pot = self.potential
        return torch.randn(shape, generator=self.generator, dtype=pot.dtype, device=pot.device)

    def _uniform(self, shape):
        pot = self.potential
        return torch.rand(shape, generator=self.generator, dtype=pot.dtype, device=pot.device)

    def _cold(self, positions):
        """Converged evaluations of each replica: (E [R], F, dipoles or
        None, healthy [R] on the host)."""
        out = [ef(p, None, self.state.box) for ef, p in zip(self._efs, positions)]
        e = torch.stack([o[0] for o in out])
        f = torch.stack([o[1] for o in out])
        ok = np.array([bool(health_flag(o[3])) for o in out])
        return e, f, [o[2] for o in out], ok

    # ------------------------------------------------------------------
    def set_positions(self, positions, box=None):
        """(Re)start from a configuration [natoms, 3] or a per-replica stack,
        with converged evaluations; resets the walkers, the exchange parity
        and the acceptance statistics."""
        self.state = initial_state(self.system, self.potential.as_positions(positions),
                                   self.temperatures, box=box)
        e, f, mu, _ = self._cold(self.state.positions)
        self.state = dataclasses.replace(self.state, forces=f, potential_energy=e)
        self._mu = mu if self._warm else None
        R = len(self.temperatures)
        self.walker = np.arange(R)
        self._parity = 0
        self._accept_sum = np.zeros(R, np.int64)
        self._exchange_attempts = np.zeros(R, np.int64)

    def set_velocities_to_temperature(self, temperatures=None):
        """Per-replica Maxwell-Boltzmann velocities at the ladder
        temperatures (or a supplied [R] override)."""
        T = self.temperatures if temperatures is None else np.asarray(temperatures, float)
        normals = self._normal(tuple(self.state.positions.shape))
        v = torch.stack([I.maxwell_boltzmann_velocities(self.system, float(T[r]), normals[r])
                         for r in range(len(T))])
        self.state = dataclasses.replace(self.state, velocities=v)

    # ------------------------------------------------------------------
    def run(self, n_blocks, check_health=True, frame_callback=None):
        """Advance n_blocks exchange blocks (n_blocks x exchange_interval MD
        steps). Returns per-block potential_energy [n_blocks, R] (kJ/mol at
        the block ends, per slot), accept [n_blocks, R], walker [n_blocks,
        R], and the cumulative per-pair `acceptance` [R-1].

        A list overflow of a reuse block raises. With check_health, a NaN
        energy or a failed converged evaluation of a replica at the end of
        the call raises RuntimeError. frame_callback(step, positions_nm,
        box) gets the cold slot's configuration (M sites placed) after each
        block; a callback with a `reporter.reportInterval` gets only the
        blocks ending on that grid."""
        assert self.state is not None, 'call set_positions first'
        R = len(self.temperatures)
        mu = self._mu if self._mu is not None else [None] * R
        pe, acc, walkers = [], [], []
        interval = getattr(getattr(frame_callback, 'reporter', None), 'reportInterval', 1) or 1
        for i in range(n_blocks):
            self.state, mu, self.walker, stats = self._block(
                self.state, mu, self.walker, (self._parity + i) % 2, self._normal,
                self._uniform)
            if bool(stats['list_overflow']):
                raise RuntimeError(
                    'REMD neighbor-list overflow during an nlist_reuse block (block %d): raise '
                    'the capacities with tune_capacities or disable nlist_reuse' % i)
            pe.append(stats['pe'][-1])
            acc.append(stats['accept'])
            walkers.append(self.walker.copy())
            if frame_callback is not None and not (interval > 1 and self.state.step % interval):
                pos = compute_virtual_sites(self.system, self.state.positions[0])
                frame_callback(self.state.step, pos.cpu().numpy(),
                               None if self.state.box is None else np.array(self.state.box))
        self._mu = mu if self._warm else None
        pe_host = torch.stack(pe).double().cpu().numpy()
        accept_host = torch.stack(acc).cpu().numpy()
        for i in range(n_blocks):
            att = np.zeros(R, np.int64)
            att[(self._parity + i) % 2:R - 1:2] = 1
            self._exchange_attempts += att
        self._accept_sum += accept_host.sum(axis=0)
        self._parity = (self._parity + n_blocks) % 2
        if check_health:
            nan = np.isnan(pe_host).any()
            ok = self._cold(self.state.positions)[3]
            if nan or not ok.all():
                raise RuntimeError('REMD health check failed: nan_in_pe=%s per_replica_ok=%s'
                                   % (bool(nan), ok.tolist()))
        att = np.maximum(self._exchange_attempts[:-1], 1)
        return dict(potential_energy=pe_host, accept=accept_host, walker=np.asarray(walkers),
                    acceptance=self._accept_sum[:-1] / att)

    # ------------------------------------------------------------------
    def checkpoint(self):
        """The ladder's state as numpy arrays: positions, velocities, forces,
        energies, box, step, the generator's state, the walkers, the parity,
        the acceptance counts, the ladder and the warm-start dipoles."""
        s = self.state
        ck = dict(positions=s.positions.cpu().numpy(), velocities=s.velocities.cpu().numpy(),
                  forces=s.forces.cpu().numpy(),
                  potential_energy=s.potential_energy.cpu().numpy(), step=np.asarray(s.step),
                  rng=self.generator.get_state().numpy(), walker=np.asarray(self.walker),
                  parity=np.asarray(self._parity), accept_sum=self._accept_sum.copy(),
                  exchange_attempts=self._exchange_attempts.copy(),
                  temperatures=self.temperatures)
        if s.box is not None:
            ck['box'] = np.asarray(s.box, np.float64)
        if self._mu is not None:
            ck['mu'] = torch.stack(self._mu).cpu().numpy()
        return ck

    def load_checkpoint(self, ck):
        if not np.allclose(ck['temperatures'], self.temperatures):
            raise ValueError('checkpoint temperature ladder differs')
        if ('mu' in ck) != self._warm:
            raise ValueError(
                'checkpoint warm-start state (mu %s) does not match this driver\'s '
                'scf_warm_start=%s - construct the driver with the same setting'
                % ('present' if 'mu' in ck else 'absent', self._warm))
        pot = self.potential

        def tensor(a):
            return torch.as_tensor(np.asarray(a), dtype=pot.dtype, device=pot.device)

        self.state = I.MDState(
            positions=tensor(ck['positions']), velocities=tensor(ck['velocities']),
            forces=tensor(ck['forces']), potential_energy=tensor(ck['potential_energy']),
            box=np.array(ck['box'], np.float64) if 'box' in ck else None, step=int(ck['step']))
        self.generator.set_state(torch.as_tensor(np.asarray(ck['rng']), dtype=torch.uint8))
        self.walker = np.asarray(ck['walker']).copy()
        self._parity = int(ck['parity'])
        self._accept_sum = np.asarray(ck['accept_sum']).copy()
        self._exchange_attempts = np.asarray(ck['exchange_attempts']).copy()
        self._mu = list(tensor(ck['mu'])) if 'mu' in ck else None

    def save_checkpoint(self, path):
        np.savez(path, **self.checkpoint())

    def load_checkpoint_file(self, path):
        with np.load(path) as z:
            self.load_checkpoint({k: z[k] for k in z.files})
