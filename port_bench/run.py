"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json's workload) names a configuration file and a
traffic mix; the run builds the port's MBPol and Simulation on the card,
draws the velocities from the seed, warms up with one short call of the
same entry, then calls Simulation.step one report chunk at a time until
`--seconds` have passed (the rate counts every step over all that time,
the report edges included). With --trace 1 it then profiles one more
chunk and reports the per-layer metrics instead of the end-to-end ones.
Once the window has closed it holds the final state against the plain
reference (port_bench/reference) and prints each number compared beside
its limit on standard error, then one JSON line on standard output.
Without a CUDA card it exits with 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from port_bench.harness import bench, spec
    chips = spec.cell(args.workload)['workload']['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'the cell needs {chips} CUDA card(s): the benchmark measures the port on cards '
              'only', file=sys.stderr)
        return 2
    result = bench.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                            t_start=T_START)
    found = bench.forbidden_modules()
    if found:
        print(f'modules of JAX or the JAX package are loaded: {found}', file=sys.stderr)
        return 3
    bench.print_result(result)
    return 0


if __name__ == '__main__':
    sys.exit(main())
