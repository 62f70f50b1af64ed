"""A cell's run on the CPU at a few steps, on the water256 box (the program
runs float64 there and takes its kernels' plain twins)."""
import io
import json
import os

from port_bench.harness import bench, spec

SEED = 2 ** 31 + 12345


def water256():
    return spec._load(os.path.join(spec.BENCH_DIR, 'configs', 'water256_bulk.json'))


def cpu_run(workload, steps=2, mix=None):
    """(result dict, the result line parsed, standard error's text); mix:
    further entries of the traffic mix replaced."""
    out, err = io.StringIO(), io.StringIO()
    result = bench.run_cell(workload, SEED, 0.0, False, device='cpu',
                            mix_overrides=dict(mix or {}, report_interval=steps),
                            config=water256(),
                            log=lambda *a: print(*a, file=err))
    bench.print_result(result, out=out, err=err)
    return result, json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()
