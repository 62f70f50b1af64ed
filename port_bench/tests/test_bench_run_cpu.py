"""A 2-step run of each traffic mix, on the water256 box on the CPU, prints
the contract's keys, its numbers beside their limits last on standard
error, and comes out correct; nothing of JAX is loaded. A mix under
Langevin and the barostat (mbpol_bulk_npt.ini's, a move every 2 steps)
runs through the same harness in the first cell's place."""
import pytest

from port_bench.harness import bench, spec

from ._cpu import cpu_run

MIXES = {}
for w in spec.benchmark()['workloads']:
    MIXES.setdefault(w['traffic'], (w['name'], None))
NPT = dict(ensemble='npt', thermostat='langevin', temperature_k=300.0, friction_per_ps=1.0,
           barostat_pressure_bar=1.01325, barostat_interval=2)
MIXES['npt'] = (spec.benchmark()['workloads'][0]['name'], NPT)


@pytest.mark.parametrize('traffic', sorted(MIXES))
def test_short_cpu_run_prints_the_contract(traffic):
    workload, mix = MIXES[traffic]
    result, line, err = cpu_run(workload, mix=mix)
    assert list(line) == ['correct', 'attempted', 'failed', 'metrics', 'device', 'checks']
    assert line['correct'] is True and line['attempted'] == 1 and line['failed'] == 0
    c = spec.cell(workload)
    assert set(line['metrics']) == {m['name'] for m in c['end_to_end']}
    for m in line['metrics'].values():
        assert set(m) == {'value', 'unit'} and m['value'] > 0
    assert set(line['checks']) == set(c['limits']['numbers'])
    tail = err.strip().splitlines()[-len(line['checks']):]
    assert all(t.startswith('check ') and ' limit ' in t for t in tail)
    assert bench.forbidden_modules() == []
    if mix is not None:
        assert 'e_trial' in err and 'e_drift' not in err
    else:
        assert 'e_drift' in err
