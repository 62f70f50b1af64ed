"""Named host spans, counters and set-up phases of the port.

Tracing is on while a `torch.profiler` records (`torch.autograd.
_profiler_enabled()`), and off while a CUDA graph is being recorded (a
recorded body runs nothing). To read a run, profile it as usual:

    from torch.profiler import ProfilerActivity, profile
    from mbpol_openmm_plugin_tpu_torch.utils import tracing

    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sim.step(50, report_interval=50)
    tracing.counters()   # {'host_reads': 37, 'scf_solves': 2, ...}: the profiled calls
    tracing.phases()     # {'md.step_graph.capture': {'first_s', 'count', 'total_s'}, ...}

`span(name)` is a `record_function(name)` range, so each span lands in the
profile's trace beside the device's operations, on the same clock; with no
profiler it returns one shared no-op object after a single check.
`count(name, n)` adds to a counter while tracing is on, and `enabled()`
says whether it is (for a count that needs a host read of its own).
`phase(name)` is a span that also always keeps the host duration
(`time.perf_counter`) of one-off work, profiled or not: the first one's,
the count and the total by name. `reset()` clears the counters and the
phases.

Spans (the program's layers; each name is unique in the port):

    md.simulation.chunk          one report chunk of Simulation.step
    md.simulation.readback       the energies read to the host: at the
                                 call's start, and each chunk's per-step
                                 PE and KE
    md.simulation.health_check   the overflow flag, the converged
                                 diagnostic evaluation and its flags, the
                                 chunk's last kinetic energy
    md.simulation.dipole_seed    the seed of a chunk's dipole history: the
                                 last health check's converged dipoles
                                 where it evaluated the same state, else
                                 a converged evaluation
    md.simulation.group_lists    the lists built at a group's start
    md.simulation.barostat_move  one Monte Carlo volume move
    md.simulation.barostat_trial one of its two converged evaluations
    md.step_graph.group          a group of steps (Simulation, PIMDSimulation):
                                 draws, loads, steps, copies, unload
    md.step_graph.replay         one CUDA graph replay
    models.potential.evaluate    MBPol._energy_forces_impl run eagerly, with
      models.potential.lists         its lists,
      models.potential.smooth_terms  the closed-form terms and their forces,
      models.potential.electrostatics  and the electrostatics
    models.electrostatics.scf    an SOR or DIIS loop of a converged solve
    models.electrostatics.scf_stop_test  one iteration's host read of epsilon
    models.pme.block_sites       block mode: the sorted, packed sites and
                                 the active tile-pair lists of one
                                 evaluation
    models.pme.block_lines       block mode: K1-bs with its cluster-box
                                 pre-pass, the fixed field and the s3/s5
                                 factors of the live lines

Counters: host_reads (reads of device values on the host: the readback,
the health check, the SCF stop tests, a barostat move's uniforms and
energies), list_builds (lists at a group's start), graph_replays,
scf_solves (SOR or DIIS loops), scf_iterations (their iterations),
dipole_seeds (the seeds of chunks' dipole histories),
dipole_seed_reuses (those taken from the last health check), and in block
mode elec_tile_pairs (the active tile pairs of the health check's
converged evaluation, summed) and elec_tile_reads (the evaluations read).

Phases: ops._build.load (the kernel library found or built),
models.potential.init, models.potential.tune_capacities,
models.potential.block_layout (inside it in block mode: the serpentine
site sort and the tile-pair and line counts),
md.simulation.set_positions (its converged evaluation),
md.step_graph.eager_step and md.step_graph.capture (the first step at a
box, and its recording into a graph).
"""
from __future__ import annotations

import time

import torch
from torch.autograd.profiler import record_function

_counters = {}
_phases = {}


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def _capturing():
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def enabled():
    """True while tracing is on: a torch.profiler records and no CUDA graph
    is being recorded."""
    return torch.autograd._profiler_enabled() and not _capturing()


def span(name):
    """A record_function(name) range while tracing is on, else NO_SPAN."""
    return record_function(name) if enabled() else NO_SPAN


def count(name, n=1):
    """Add n to the counter `name` while tracing is on."""
    if enabled():
        _counters[name] = _counters.get(name, 0) + n


class phase:
    """A span around one-off work that also keeps its host duration, traced
    or not: `seconds` after the block, and under `name` in phases()."""
    __slots__ = ('name', 'seconds', '_span', '_t0')

    def __init__(self, name):
        self.name = name
        self.seconds = None

    def __enter__(self):
        self._span = span(self.name)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        p = _phases.get(self.name)
        if p is None:
            _phases[self.name] = dict(first_s=self.seconds, count=1, total_s=self.seconds)
        else:
            p['count'] += 1
            p['total_s'] += self.seconds
        return False


def counters():
    """{name: count} since the last reset()."""
    return dict(_counters)


def phases():
    """{name: dict(first_s, count, total_s)} since the last reset()."""
    return {k: dict(v) for k, v in _phases.items()}


def reset():
    """Clear the counters and the phases."""
    _counters.clear()
    _phases.clear()
