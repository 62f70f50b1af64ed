"""The water4096 cell's readers and configuration on the CPU.

(a) elec_block_roofline: None without a trace, without the work counts or
    without any of the three block kernels in the trace; the bounds counted
    by hand at water256's numbers; the share over a hand-made trace.
(b) tile_pair_density.block: None without the program's counters (a
    program that does not count the tile pairs, or no tracing module), or
    without a trace; the covered pairs counted by hand at water4096.
(c) The cell's configuration with replicas [1, 1, 1] and 256 waters runs
    through the harness on the CPU (float64, the kernels' plain twins) and
    comes out correct.
"""
import copy
import importlib.util
import os
import sys

import pytest

from port_bench.harness import bench, program_trace, spec

from ._cpu import SEED

WORKLOAD = 'water4096_bulk.nve_r50'
RATE = 1e15
# water256: 1,024 sites, 216,468 unordered in-cutoff pairs (PERF.md section 6)
N_SITES, N_IN = 1024, 216468
KERNELS = {'fixed_field_bs_kernel': (2e-3, 2), 'scf_field_bs_kernel': (3e-3, 10),
           'direct_efp_bs_kernel': (1e-3, 2), 'cluster_boxes_kernel': (1e-4, 4),
           'fixed_field_tri_kernel': (5e-3, 1)}


def _metric_module(name):
    """A reader's module (its file name holds a dot, so no plain import)."""
    path = os.path.join(spec.BENCH_DIR, 'metrics', name + '.py')
    mod_spec = importlib.util.spec_from_file_location('block_cell_test_' + name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def test_block_bounds_by_hand():
    b = _metric_module('elec_block_roofline').block_bounds(N_SITES, N_IN, RATE)
    # K1-bs: sites 8 floats, field 3, one s3/s5 pair per in-cutoff pair: bytes
    assert b['fixed_field_bs_kernel'] == pytest.approx(
        (1024 * 32 + 1024 * 12 + 216468 * 8) / 3.35e12, rel=1e-12)
    # K3-bs: sites, dipoles, the s3/s5 pairs and the field: bytes
    assert b['scf_field_bs_kernel'] == pytest.approx(
        (1024 * 32 + 1024 * 12 + 216468 * 8 + 1024 * 12) / 3.35e12, rel=1e-12)
    # K2-bs: 25 + 150 operations a pair
    assert b['direct_efp_bs_kernel'] == pytest.approx(216468 * 175 / 67e12, rel=1e-12)


def test_elec_block_roofline_share():
    b = _metric_module('elec_block_roofline').block_bounds(N_SITES, N_IN, RATE)
    ctx = dict(trace=dict(kernels=KERNELS), work=dict(n_sites=N_SITES, n_in=N_IN, rate=RATE))
    want = 100 * (2 * b['fixed_field_bs_kernel'] + 10 * b['scf_field_bs_kernel']
                  + 2 * b['direct_efp_bs_kernel']) / (2e-3 + 3e-3 + 1e-3 + 1e-4)
    assert bench.read_metric('elec_block_roofline', ctx) == pytest.approx(want, rel=1e-12)
    assert 0 < want < 100


def test_elec_block_roofline_none():
    work = dict(n_sites=N_SITES, n_in=N_IN, rate=RATE)
    assert bench.read_metric('elec_block_roofline', {}) is None
    assert bench.read_metric('elec_block_roofline', dict(trace=dict(kernels=KERNELS))) is None
    assert bench.read_metric('elec_block_roofline', dict(
        trace=dict(kernels=KERNELS), work=dict(work, rate=None))) is None
    dense = {'fixed_field_tri_kernel': (5e-3, 1), 'direct_efp_tri_kernel': (1e-3, 1)}
    assert bench.read_metric('elec_block_roofline', dict(trace=dict(kernels=dense),
                                                         work=work)) is None


def test_covered_pairs_by_hand():
    covered = _metric_module('tile_pair_density.block').covered_pairs
    # water4096: 64 row tiles, 3,682 active entries: 64 diagonal, 1,809 off-diagonal pairs
    assert covered(3682, 16384) == 64 * 256 * 255 // 2 + 1809 * 256 * 256 == 120643584
    # water256: 4 row tiles, all 16 entries: every unordered pair of 1,024 sites
    assert covered(16, 1024) == 1024 * 1023 // 2


@pytest.mark.parametrize('reads', [1, 2])
def test_tile_pair_density(monkeypatch, reads):
    monkeypatch.setattr(program_trace, 'program', lambda: (
        dict(elec_tile_pairs=3682 * reads, elec_tile_reads=reads, host_reads=24), {}))
    ctx = dict(trace=dict(steps=50), work=dict(n_sites=16384, n_in=3460000, rate=RATE))
    assert bench.read_metric('tile_pair_density.block', ctx) == pytest.approx(
        100 * 3460000 / 120643584, rel=1e-12)


def test_tile_pair_density_none(monkeypatch):
    ctx = dict(trace=dict(steps=50), work=dict(n_sites=16384, n_in=3460000, rate=RATE))
    monkeypatch.setattr(program_trace, 'program', lambda: (dict(host_reads=23), {}))
    assert bench.read_metric('tile_pair_density.block', ctx) is None
    monkeypatch.setattr(program_trace, 'program', lambda: (
        dict(elec_tile_pairs=3682, elec_tile_reads=1), {}))
    assert bench.read_metric('tile_pair_density.block', dict(ctx, trace=None)) is None
    assert bench.read_metric('tile_pair_density.block', dict(trace=ctx['trace'])) is None


def test_tile_pair_density_without_the_tracing_module(monkeypatch):
    import mbpol_openmm_plugin_tpu_torch.utils as utils
    monkeypatch.delattr(utils, 'tracing', raising=False)
    monkeypatch.setitem(sys.modules, 'mbpol_openmm_plugin_tpu_torch.utils.tracing', None)
    ctx = dict(trace=dict(steps=50), work=dict(n_sites=16384, n_in=3460000, rate=RATE))
    assert bench.read_metric('tile_pair_density.block', ctx) is None


def test_cell_config_runs_correct_on_the_cpu():
    config = copy.deepcopy(spec.cell(WORKLOAD)['config'])
    config.update(replicas=[1, 1, 1], n_waters=256)
    result = bench.run_cell(WORKLOAD, SEED, 0.0, False, device='cpu',
                            mix_overrides=dict(report_interval=2), config=config,
                            log=lambda *a: None)
    assert result['correct'] is True, result['checks']
    assert set(result['metrics']) == {'nve_ns_per_day.dense', 'setup_s'}
