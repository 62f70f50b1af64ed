"""Readings that set a cell's limits: the program's numbers over many seeds
(the lower readings) and the control's over a few (the upper readings).

    python3 port_bench/control.py --workload <name> --seeds <n> ... \
        [--control <k>] [--chunks <c>] [--out <file.jsonl>]

For each seed it runs the cell's set-up, warm-up and `--chunks` report
chunks through the program on the card, then compares the final state with
the float64 reference (port_bench/reference), as a benchmark run does. For
the first `--control` seeds it also puts the control in the program's
place: the same reference computed in float32 with TF32 matrix products
allowed (the precision below the configuration's float32 with TF32 off),
at the same states, and compares it the same way. For every seed it also
reads the fault of each energy term left out of the program's answer (the
term's energy taken out of the converged evaluation and of the step's
energy). One JSON line per seed; the benchmark's own runs never run the
control.
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def term_left_out(values, term):
    """The program's values (compare.program_values) with one energy term
    left out of its answer."""
    e = values['terms'][term]
    return dict(values, terms=dict(values['terms'], **{term: 0.0}),
                pe_step=values['pe_step'] - e)


def readings_of_seed(c, seed, chunks, control, device='cuda', config=None, mix=None):
    """{'program': readings, 'control': readings or None, ...} of one seed."""
    import numpy as np
    import torch
    from port_bench.harness import compare, sut
    config = c['config'] if config is None else config
    mix = c['mix'] if mix is None else mix
    t0 = time.perf_counter()
    run = sut.Run(config, mix, seed, device=device)
    run.warm_up(int(mix['warmup_steps']))
    start = run.snapshot()
    for _ in range(chunks):
        run.chunk()
    prog = compare.program_outputs(run, start)
    masses = np.asarray(run.system.masses)
    del run
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ref = compare.Reference(config, mix, masses, device)
    ref_out = ref.outputs(prog['positions'], prog['box'], prog['warmup'], prog.get('trial'),
                          prog.get('window'))
    values = compare.program_values(prog)
    out = dict(seed=seed, program=compare.readings(values, ref_out, prog['warmup'], masses),
               run_s=t1 - t0, reference_s=time.perf_counter() - t1, control=None,
               reference_terms=ref_out['terms'],
               term_left_out={k: compare.readings(term_left_out(values, k), ref_out,
                                                  prog['warmup'], masses)
                              for k in compare.TERMS})
    if control:
        ctl = compare.Reference(config, mix, masses, device, dtype=torch.float32)
        ctl_out = ctl.outputs(prog['positions'], prog['box'], prog['warmup'], prog.get('trial'))
        out['control'] = compare.readings(ctl.as_program(ctl_out), ref_out, prog['warmup'],
                                          masses)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--control', type=int, default=3)
    ap.add_argument('--chunks', type=int, default=1)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print('no CUDA card', file=sys.stderr)
        return 2
    from port_bench.harness import spec, sut
    sut.build_kernels()
    c = spec.cell(args.workload)
    for i, seed in enumerate(args.seeds):
        line = json.dumps(dict(workload=args.workload, **readings_of_seed(
            c, seed, args.chunks, i < args.control)))
        print(line, flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
