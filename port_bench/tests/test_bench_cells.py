"""Every cell of BENCHMARK.json loads as data, and the file keeps the
benchmark's shape: names, units, bounds, paths, readers and limits."""
import json
import os
import re

import pytest

from port_bench.harness import spec

BENCH = spec.benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
WORKLOADS = [w['name'] for w in BENCH['workloads']]


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                          'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['port_bench']
    assert BENCH['command'][1].startswith('port_bench/')
    assert os.path.getsize(os.path.join(spec.ROOT, 'BENCHMARK.json')) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = BENCH['run_seconds']
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize('workload', WORKLOADS)
def test_cell_loads(workload):
    c = spec.cell(workload)
    assert NAME.match(workload) and c['workload']['chips'] == 1
    assert len(c['workload']['why']) <= 200
    assert c['config']['name'] == c['workload']['config']
    for key in ('positions', 'n_waters', 'replicas', 'box_nm', 'cutoff', 'timestep_fs',
                'electrostatics_mode', 'dispersion_mode', 'assumed'):
        assert key in c['config'], key
    assert os.path.exists(spec.config_path(c['config'], 'positions'))
    for key in ('ensemble', 'report_interval', 'warmup_steps', 'initial_temperature_k'):
        assert key in c['mix'], key
    names = {m['name'] for m in c['end_to_end']}
    assert 'setup_s' in names and len(names) >= 2
    assert c['per_layer'], 'a cell reports at least one per-layer metric'
    assert c['limits']['numbers'] and all(v > 0 for v in c['limits']['numbers'].values())


def test_configs_and_metrics():
    used = {w['config'] for w in BENCH['workloads']}
    assert used == {c['name'] for c in BENCH['configs']}
    files = [c['file'] for c in BENCH['configs']]
    assert len(set(files)) == len(files)
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('port_bench/') and os.path.exists(
            os.path.join(spec.ROOT, c['file']))
        assert all(NAME.match(k) for k in c['reduced'])
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert e2e['setup_s']['bound'] <= 0.25
    for m in BENCH['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25 and m['source'] in ('host_clock', 'device_trace')
    names = [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    assert len(set(names)) == len(names)
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
        assert set(m.get('workloads', WORKLOADS)) <= set(WORKLOADS)
    for m in BENCH['per_layer']:
        assert m['moves'] in e2e
        assert os.path.exists(os.path.join(spec.BENCH_DIR, 'metrics', m['name'] + '.py'))
        for w in m.get('workloads', WORKLOADS):
            reports = e2e[m['moves']].get('workloads', WORKLOADS)
            assert w in reports, (m['name'], w)
        if m['name'].endswith('_roofline'):
            assert m['unit'] == '%'


def test_limits_files_name_known_numbers():
    known = {'pe_step', 'f_step', 'f_conv', 'dv_warmup', 'e_trial', 'f_trial',
             'e_one_body', 'e_two_body', 'e_three_body', 'e_dispersion', 'e_electrostatics',
             'e_drift'}
    for w in WORKLOADS:
        with open(os.path.join(spec.BENCH_DIR, 'limits', w + '.json')) as f:
            assert set(json.load(f)['numbers']) <= known
