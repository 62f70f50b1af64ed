"""The reader of seed_reuse_share.dense (metrics/seed_reuse_share.dense.py)
on hand-made counters: the share of a profiled chunk's dipole seeds that
reused the health check's dipoles, None where the program counts no seeds
(a program without the reuse, or without its tracing module) or there is
no profiled chunk."""
import sys

import pytest

from port_bench.harness import bench, program_trace

NAME = 'seed_reuse_share.dense'
TRACE = dict(steps=50, window_s=0.8, span_s={'md.simulation.dipole_seed': 0.001})
BASE = dict(host_reads=23, scf_solves=1, scf_iterations=14)


@pytest.mark.parametrize('counters, share', [
    (dict(dipole_seeds=1, dipole_seed_reuses=1), 100.0),
    (dict(dipole_seeds=2, dipole_seed_reuses=1), 50.0),
    (dict(dipole_seeds=1), 0.0),
], ids=['every_seed_reused', 'one_of_two', 'none_reused'])
def test_reader(monkeypatch, counters, share):
    monkeypatch.setattr(program_trace, 'program', lambda: (dict(BASE, **counters), {}))
    assert bench.read_metric(NAME, {'trace': dict(TRACE)}) == pytest.approx(share)


@pytest.mark.parametrize('counters', [dict(BASE), dict(BASE, dipole_seeds=0)],
                         ids=['no_seed_counters', 'no_seeds'])
def test_reader_with_no_seeds(monkeypatch, counters):
    monkeypatch.setattr(program_trace, 'program', lambda: (counters, {}))
    assert bench.read_metric(NAME, {'trace': dict(TRACE)}) is None


def test_reader_without_a_profiled_chunk(monkeypatch):
    monkeypatch.setattr(program_trace, 'program',
                        lambda: (dict(BASE, dipole_seeds=1, dipole_seed_reuses=1), {}))
    assert bench.read_metric(NAME, {}) is None


def test_reader_without_the_program(monkeypatch):
    import mbpol_openmm_plugin_tpu_torch.utils as utils
    monkeypatch.delattr(utils, 'tracing', raising=False)
    monkeypatch.setitem(sys.modules, 'mbpol_openmm_plugin_tpu_torch.utils.tracing', None)
    assert bench.read_metric(NAME, {'trace': dict(TRACE)}) is None
