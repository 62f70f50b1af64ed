"""Cells by name: BENCHMARK.json's workload entry, its configuration file,
its traffic mix (`mixes/<traffic>.json`) and its limits
(`limits/<workload>.json`). Nothing here imports the program."""
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return _load(os.path.join(root, 'BENCHMARK.json'))


def cell(workload, root=ROOT):
    """dict(workload, config, mix, limits, end_to_end, per_layer) of one cell:
    the end-to-end and per-layer metrics are those of BENCHMARK.json that
    this cell reports."""
    bench = benchmark(root)
    wl = next((w for w in bench['workloads'] if w['name'] == workload), None)
    if wl is None:
        raise KeyError(f'no workload {workload!r} in BENCHMARK.json')
    cfg_entry = next(c for c in bench['configs'] if c['name'] == wl['config'])
    config = _load(os.path.join(root, cfg_entry['file']))
    mix = _load(os.path.join(BENCH_DIR, 'mixes', wl['traffic'] + '.json'))
    limits = _load(os.path.join(BENCH_DIR, 'limits', workload + '.json'))

    def mine(m):
        return workload in m.get('workloads', [workload])

    return dict(workload=wl, config=config, mix=mix, limits=limits,
                end_to_end=[m for m in bench['end_to_end'] if mine(m)],
                per_layer=[m for m in bench['per_layer'] if mine(m)],
                run_seconds=bench['run_seconds'])


def config_path(config, key):
    """A file that a configuration names, relative to the benchmark folder."""
    return os.path.join(BENCH_DIR, config[key])
