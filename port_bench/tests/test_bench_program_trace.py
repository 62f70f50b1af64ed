"""The readers of the program's spans, counters and set-up phases
(harness/program_trace.py) on hand-made readings, each None where the
program has nothing to read, and an idle gap labelled by the program's
innermost span inside the benchmark's."""
import sys

import pytest

from port_bench.harness import bench, program_trace, trace
from port_bench.tests.test_bench_trace import CPU, GPU, Ev

COUNTERS = dict(host_reads=31, scf_solves=2, scf_iterations=24, graph_replays=50)
PHASES = {'md.step_graph.eager_step': dict(first_s=4.0, count=1, total_s=4.0),
          'md.step_graph.capture': dict(first_s=0.5, count=2, total_s=0.9),
          'md.simulation.set_positions': dict(first_s=3.0, count=1, total_s=3.0)}
TRACE = dict(steps=50, window_s=0.8, span_s={
    'md.simulation.dipole_seed': 0.05, 'md.simulation.readback': 0.01,
    'md.simulation.health_check': 0.06, 'md.step_graph.replay': 0.2,
    'models.potential.converged_eval': 0.1})
METRICS = {'edge_host_share.dense': 15.0, 'host_reads_per_chunk.dense': 31,
           'scf_iterations_per_solve.dense': 12.0, 'replay_host_ms_per_step.dense': 4.0,
           'setup_capture_s': 4.5, 'setup_first_eval_s': 3.0}


@pytest.fixture
def program(monkeypatch):
    monkeypatch.setattr(program_trace, 'program', lambda: (dict(COUNTERS), dict(PHASES)))


@pytest.mark.parametrize('name', sorted(METRICS))
def test_reader(program, name):
    assert bench.read_metric(name, {'trace': dict(TRACE)}) == pytest.approx(METRICS[name])


@pytest.mark.parametrize('name', sorted(METRICS))
def test_reader_without_the_program(monkeypatch, name):
    """The program before its tracing module: no spans, no counters, no
    phases."""
    import mbpol_openmm_plugin_tpu_torch.utils as utils
    monkeypatch.delattr(utils, 'tracing', raising=False)
    monkeypatch.setitem(sys.modules, 'mbpol_openmm_plugin_tpu_torch.utils.tracing', None)
    assert program_trace.program() is None
    bench_spans = {'models.potential.converged_eval': 0.1}
    assert bench.read_metric(name, {'trace': dict(TRACE, span_s=bench_spans)}) is None


def test_readers_with_nothing_to_read(monkeypatch):
    monkeypatch.setattr(program_trace, 'program', lambda: ({}, {}))
    for name in METRICS:
        assert bench.read_metric(name, {'trace': dict(TRACE, span_s={})}) is None, name
    monkeypatch.setattr(program_trace, 'program', lambda: (dict(COUNTERS), dict(PHASES)))
    for name in ('host_reads_per_chunk.dense', 'scf_iterations_per_solve.dense',
                 'edge_host_share.dense', 'replay_host_ms_per_step.dense'):
        assert bench.read_metric(name, {}) is None, name
    monkeypatch.setattr(program_trace, 'program',
                        lambda: (dict(COUNTERS, scf_solves=0), {}))
    assert bench.read_metric('scf_iterations_per_solve.dense', {'trace': TRACE}) is None


def test_program_reads_the_tracing_module():
    from mbpol_openmm_plugin_tpu_torch.utils import tracing
    counters, phases = program_trace.program()
    assert counters == tracing.counters() and phases == tracing.phases()


def test_gap_labelled_by_the_programs_replay_span():
    events = [Ev('bench.chunk', CPU, 0, 1000),
              Ev('md.step_graph.replays', CPU, 0, 1000),
              Ev('md.step_graph.group', CPU, 10, 990),
              Ev('md.step_graph.replay', CPU, 300, 700),
              Ev('k', GPU, 0, 400), Ev('k', GPU, 600, 1000)]
    r = trace.reduce_events(events, 2, 1e-6)
    assert r['idle_gaps'] == [['md.step_graph.replay', pytest.approx(200e-9)]]
    assert r['span_s']['md.step_graph.replay'] == pytest.approx(400e-9)
