"""The port's block-mode spans, phase and counters (utils/tracing.py) on the
CPU, float64: upstream's water256 box (port_bench/configs) under
MBPolConfig.for_dynamics in block electrostatics and pair dispersion with
tuned capacities, one NVE step a run with the health check.

(a) tune_capacities keeps the phase models.potential.block_layout, profiled
    or not.
(b) Under torch.profiler, a chunk's evaluations run models.pme.block_sites
    and models.pme.block_lines inside models.potential.electrostatics, and
    the health check reads its evaluation's active tile pairs once:
    elec_tile_reads 1, elec_tile_pairs that evaluation's count (16: the box
    has 4 row tiles, each within the cutoff of every other).
(c) With no profiler a chunk counts nothing and makes no read of the
    tile pairs (the count is never converted to a host number).
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.system import (System, compute_virtual_sites,
                                                  make_molecules_whole)
from mbpol_openmm_plugin_tpu_torch.utils import tracing
from port_bench.harness import sut
from port_bench.tests._cpu import water256

STEPS = 1


def _sim():
    config = water256()
    names, resnames, positions = sut.load_positions(config)
    system = System.from_atom_names(names, resnames, box=[config['box_nm']] * 3)
    pos = compute_virtual_sites(system, make_molecules_whole(system, torch.as_tensor(positions)))
    pot = MBPol(system, MBPolConfig.for_dynamics(electrostatics_mode='block',
                                                 dispersion_mode='pairs'), device='cpu')
    pot.tune_capacities(pos)
    sim = Simulation(pot, SimulationConfig(dt=0.0002), seed=11)
    sim.set_positions(pos)
    sim.set_velocities_to_temperature(300.0)
    return sim


class _Reads:
    """Counts host conversions of the health check's elec_tile_pairs."""

    def __init__(self, monkeypatch, sim):
        self.n = 0
        impl = sim.potential._energy_forces_impl
        reads = self

        class Counted(torch.Tensor):
            def __int__(self):
                reads.n += 1
                return int(self.as_subclass(torch.Tensor))

        def counted(*a, **k):
            e, f, parts, diag = impl(*a, **k)
            if 'elec_tile_pairs' in diag:
                diag = dict(diag, elec_tile_pairs=diag['elec_tile_pairs'].as_subclass(Counted))
            return e, f, parts, diag
        monkeypatch.setattr(sim.potential, '_energy_forces_impl', counted)


@pytest.fixture(scope='module')
def runs():
    """One start stepped without, then with the profiler (the traced chunk
    seeds its dipoles from the quiet chunk's health check)."""
    tracing.reset()
    with pytest.MonkeyPatch.context() as m:
        sim = _sim()
        phases = tracing.phases()
        reads = _Reads(m, sim)
        sim.step(STEPS)
        quiet_counters, quiet_reads = tracing.counters(), reads.n
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            sim.step(STEPS)
    spans = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
             if e.name().startswith(('md.', 'models.'))]
    return dict(phases=phases, quiet_counters=quiet_counters, quiet_reads=quiet_reads,
                counters=tracing.counters(), spans=spans, traced_reads=reads.n - quiet_reads)


def test_block_layout_phase(runs):
    p = runs['phases']['models.potential.block_layout']
    assert p['count'] == 1 and 0 < p['first_s'] <= runs['phases'][
        'models.potential.tune_capacities']['first_s']


def test_traced_chunk_block_spans_and_tile_counters(runs):
    spans, c = runs['spans'], runs['counters']
    outer = [(a, b) for n, a, b in spans if n == 'models.potential.electrostatics']
    for name in ('models.pme.block_sites', 'models.pme.block_lines'):
        inner = [(a, b) for n, a, b in spans if n == name]
        assert inner and all(any(oa <= a and b <= ob for oa, ob in outer) for a, b in inner)
    assert c['elec_tile_reads'] == 1 and runs['traced_reads'] == 1
    assert c['elec_tile_pairs'] == 16
    # the health check's reads: the overflow flag, the health flag's, the tile pairs
    assert c['host_reads'] >= c['scf_iterations'] + 4


def test_untraced_chunk_counts_and_reads_nothing(runs):
    assert runs['quiet_counters'] == {}
    assert runs['quiet_reads'] == 0
