"""The system under test: the port's MBPol and Simulation, built from a
configuration file and a traffic mix, and the benchmark's hooks on them.

This is the only module of the benchmark that imports the program. The
hooks wrap attributes of one Simulation instance to keep references to
what its calls return (no copy, no host read), so the comparison can see
the first group of steps and the barostat's last trial evaluation.
"""
import dataclasses

import numpy as np
import torch

from . import spec


def load_positions(config):
    """(names, resnames, positions [4n, 3] float64 nm) of the starting box."""
    with np.load(spec.config_path(config, 'positions')) as z:
        return z['names'], z['resnames'], np.asarray(z['positions'], np.float64)


def build_kernels():
    """Build (or find in the checkout's cache) the program's CUDA library."""
    from mbpol_openmm_plugin_tpu_torch.ops import _build
    _build.load()


class Run:
    """One cell's program objects: the potential and the Simulation at the
    starting positions, with velocities drawn by the benchmark from the
    seed, on `device`."""

    def __init__(self, config, mix, seed, device='cuda'):
        from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
        from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
        from mbpol_openmm_plugin_tpu_torch.system import (System, compute_virtual_sites,
                                                          make_molecules_whole, replicate)
        self.device = torch.device(device)
        names, resnames, positions = load_positions(config)
        box = [float(config['box_nm'])] * 3
        system = System.from_atom_names(names, resnames, box=box)
        dtype = torch.float32 if self.device.type == 'cuda' else torch.float64
        pos = torch.as_tensor(positions, dtype=dtype, device=self.device)
        pos = compute_virtual_sites(system, make_molecules_whole(system, pos))
        if tuple(config['replicas']) != (1, 1, 1):
            system, pos = replicate(system, pos, tuple(config['replicas']))
            pos = compute_virtual_sites(system, pos)
        if system.n_waters != int(config['n_waters']):
            raise ValueError(f'{system.n_waters} waters, the configuration says '
                             f'{config["n_waters"]}')
        self.system = system
        cfg = MBPolConfig.for_dynamics(
            cutoff=float(config['cutoff']), cutoff_2b=float(config['cutoff_2b']),
            cutoff_3b=float(config['cutoff_3b']),
            ewald_error_tolerance=float(config['ewald_error_tolerance']),
            target_epsilon=float(config['target_epsilon']), aspc_k=int(config['aspc_k']),
            aspc_n_corr=int(config['aspc_n_corr']), nlist_skin=float(config['nlist_skin']),
            dispersion_switch_width=float(config['dispersion_switch_width']),
            electrostatics_mode=config['electrostatics_mode'],
            dispersion_mode=config['dispersion_mode'])
        pot = MBPol(system, cfg, device=self.device)
        if config['tune_capacities']:
            pot.tune_capacities(pos)
        if 'nlist_kt' in config:
            # the triplet slots per centre as the configuration states them
            # (null: every centre's candidates kept)
            pot.nlist_kt = config['nlist_kt']
        npt = mix['ensemble'] == 'npt'
        sim_cfg = SimulationConfig(
            dt=float(config['timestep_fs']) * 1e-3,
            temperature=float(mix['temperature_k']) if npt else None,
            thermostat=mix.get('thermostat', 'none') if npt else 'none',
            friction=float(mix.get('friction_per_ps', 1.0)),
            barostat_pressure=float(mix['barostat_pressure_bar']) if npt else None,
            barostat_interval=int(mix.get('barostat_interval', 25)),
            nlist_rebuild_interval=mix['nlist_rebuild_interval'])
        self.sim = Simulation(pot, sim_cfg, seed=seed)
        self.sim.set_positions(pos)
        self.sim.state = dataclasses.replace(self.sim.state, velocities=initial_velocities(
            system.masses, float(mix['initial_temperature_k']), seed, pos))
        self.dt_ps = sim_cfg.dt
        self.report_interval = int(mix['report_interval'])
        self.check_health = bool(mix['check_health'])
        self._hook()

    # ------------------------------------------------------------ hooks
    def _hook(self):
        sim = self.sim
        self.groups = []         # (state in, state out, draws) of the first group
        self.trials = []         # (positions, box, energy, forces) of the barostat's calls
        group, draws, energy_at = sim._group, sim._draws, sim._energy_at
        self._recording_draws = None

        def draws_hook():
            d = draws()
            if self._recording_draws is not None:
                self._recording_draws.append(d)
            return d

        def group_hook(state, nlists, run, n):
            if self.groups:
                return group(state, nlists, run, n)
            self._recording_draws = []
            out = group(state, nlists, run, n)
            self.groups.append((state, out[0], self._recording_draws))
            self._recording_draws = None
            return out

        def energy_at_hook(run):
            fn = energy_at(run)

            def call(p, box):
                e, f = fn(p, box)
                self.trials = (self.trials + [(p, np.array(box, np.float64), e, f)])[-2:]
                return e, f
            return call

        sim._draws, sim._group, sim._energy_at = draws_hook, group_hook, energy_at_hook

    # ------------------------------------------------------------ driving
    def chunk(self):
        """One report chunk through the user's call; returns its steps."""
        n = self.report_interval
        self.sim.step(n, report_interval=n, check_health=self.check_health)
        return n

    def warm_up(self, steps):
        """The cell's warm-up: one short call of the same entry (it captures
        the step graph; under a barostat it ends with a move)."""
        self.sim.step(steps, report_interval=steps, check_health=self.check_health)

    def converged(self):
        """The program's converged evaluation at the current state, the call
        the health check makes: (energy, forces, {term: energy})."""
        s = self.sim.state
        e, f, parts, _ = self.sim.potential.energy_forces(s.positions, box=s.box)
        return e, f, parts

    def snapshot(self):
        """Host float64 copies of the current state's positions, velocities
        and box (the start of the timed window, for the energy drift)."""
        s = self.sim.state
        return dict(x=s.positions.detach().to('cpu', torch.float64).numpy(),
                    v=s.velocities.detach().to('cpu', torch.float64).numpy(),
                    box=np.array(s.box, np.float64))

    def captures(self):
        return list(self.sim.capture_ms)

    def wrap_spans(self, record_function):
        """Name in a profile the host's step groups (replays, and after a new
        box the eager step and the capture) and the potential's evaluations:
        converged ones (chunk edges, barostat trials) and, inside an eager
        step, those with a dipole predictor (benchmark spans around the
        calls into the program's layers)."""
        sim, pot = self.sim, self.sim.potential
        impl, group = pot._energy_forces_impl, sim._group

        def impl_span(*a, **k):
            mu0 = a[1] if len(a) > 1 else k.get('mu0')
            with record_function('models.potential.converged_eval' if mu0 is None
                                 else 'models.potential.predicted_eval'):
                return impl(*a, **k)

        def group_span(*a, **k):
            with record_function('md.step_graph.replays'):
                return group(*a, **k)

        pot._energy_forces_impl, sim._group = impl_span, group_span


def initial_velocities(masses, temperature_k, seed, like):
    """Maxwell-Boltzmann velocities at temperature_k (zero on the massless M
    sites), the centre-of-mass velocity removed, from a generator on the
    device seeded with the seed, in like's dtype."""
    gen = torch.Generator(device=like.device)
    gen.manual_seed(int(seed) % (1 << 63))
    m = np.asarray(masses, np.float64)
    normals = torch.randn(like.shape, generator=gen, device=like.device, dtype=torch.float64)
    sigma = np.where(m > 0, np.sqrt(0.00831446261815324 * temperature_k
                                    / np.where(m > 0, m, 1.0)), 0.0)
    v = normals * torch.as_tensor(sigma, device=like.device)[:, None]
    mt = torch.as_tensor(m, device=like.device)[:, None]
    v = torch.where(mt > 0, v - torch.sum(mt * v, dim=0) / torch.sum(mt), v)
    return v.to(like.dtype)

