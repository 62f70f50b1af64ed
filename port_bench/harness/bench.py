"""One run of one cell: set-up, the timed window, the traced chunk (with
--trace 1), the comparison with the reference, and the result line."""
import gc
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

from . import compare, readers, spec
from .spec import BENCH_DIR

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'mbpol_openmm_plugin_tpu')


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({k.split('.')[0] for k in sys.modules} & set(FORBIDDEN))


def read_metric(name, ctx):
    """The per-layer metric `name` by its reader, metrics/<name>.py (None
    when the reader finds nothing to read)."""
    path = os.path.join(BENCH_DIR, 'metrics', name + '.py')
    mod_spec = importlib.util.spec_from_file_location('port_bench_metric_' + name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read(ctx)


def card():
    """(device dict without the peak, nvidia-smi name and power limit)."""
    from .roofline import smi
    return (dict(platform='gpu', kind=torch.cuda.get_device_name(0), count=1),
            smi('name,power.limit'))


def run_cell(workload, seed, seconds, trace, device='cuda', t_start=None, log=None,
             mix_overrides=None, config=None):
    """The result dict of one run (the contract's keys, `checks` last).
    mix_overrides: mix entries replaced; config: a configuration in place
    of the cell's (the CPU tests' short chunks on a small box)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    c = spec.cell(workload)
    config = c['config'] if config is None else config
    mix = dict(c['mix'], **(mix_overrides or {}))
    from . import sut
    on_card = torch.device(device).type == 'cuda'
    if on_card:
        sut.build_kernels()
    run = sut.Run(config, mix, seed, device=device)
    run.warm_up(int(mix['warmup_steps']))
    start = run.snapshot()
    # the set-up's garbage collected and its survivors frozen, so that no
    # collection of the set-up's objects falls into the window
    gc.collect()
    gc.freeze()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f'set-up {setup_s:.3f} s: {config["name"]}, {run.system.n_waters} waters, '
        f'{mix["ensemble"]}, warm-up {mix["warmup_steps"]} steps, captures '
        f'{["%.1f" % x for x in run.captures()]} ms')

    # ---- the timed window: whole report chunks until `seconds` have passed
    captures0 = len(run.captures())
    steps = chunks = 0
    t0 = time.perf_counter()
    ends = []
    while True:
        steps += run.chunk()
        chunks += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gc.unfreeze()
    window = dict(steps=steps, chunks=chunks, wall_s=wall,
                  captures_ms=run.captures()[captures0:], dt_ps=run.dt_ps)
    ctx = dict(window=window, setup_s=setup_s, workload=workload, config=config, mix=mix)
    ns_per_day = readers.ns_per_day(ctx)
    log(f'window {wall:.3f} s: {chunks} chunks, {steps} steps, {steps / wall:.3f} steps/s, '
        f'{ns_per_day:.6f} ns/day, {len(window["captures_ms"])} captures; chunks '
        f'{[round(b - a, 3) for a, b in zip([0.0] + ends, ends)]} s')

    if trace:
        from . import roofline
        from .trace import profile_chunk
        t1 = time.perf_counter()
        ctx['trace'] = profile_chunk(run)
        log(f'traced chunk: {ctx["trace"]["steps"]} steps, {ctx["trace"]["wall_s"]:.3f} s, '
            f'{ctx["trace"]["n_kernels"]} kernels, busy {ctx["trace"]["busy_s"]:.4f} s; '
            f'reduction {ctx["trace"]["reduce_s"]:.1f} s, traced call '
            f'{time.perf_counter() - t1:.1f} s')
        s = run.sim.state
        sites = s.positions
        ctx['work'] = dict(n_sites=int(sites.shape[0]),
                           n_in=roofline.in_cutoff_pairs(sites, s.box, float(config['cutoff'])),
                           rate=roofline.transcendental_rate() if on_card else None)

    peak = torch.cuda.max_memory_allocated() if on_card else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f'modules of JAX or the JAX package are loaded: {found}')

    # ---- metrics: with --trace 1 the per-layer ones, else the end-to-end
    metrics = {}
    for m in c['per_layer'] if trace else c['end_to_end']:
        v = read_metric(m['name'], ctx)
        if v is not None:
            metrics[m['name']] = dict(value=float(v), unit=m['unit'])

    # ---- correctness: the program's outputs, its state freed, then the reference
    prog = compare.program_outputs(run, start)
    masses = np.asarray(run.system.masses)
    del run
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ref = compare.Reference(config, mix, masses, device)
    ref_out = ref.outputs(prog['positions'], prog['box'], prog['warmup'], prog.get('trial'),
                          prog.get('window'))
    values = compare.readings(compare.program_values(prog), ref_out, prog['warmup'], masses)
    correct, table = compare.judge(values, c['limits'])
    log(f'reference {time.perf_counter() - t1:.1f} s; readings not compared: '
        + ', '.join(f'{k} {v!r}' for k, v in values.items() if k not in table))

    result = dict(correct=correct, attempted=chunks, failed=0, metrics=metrics)
    if on_card:
        dev, smi_line = card()
        dev['memory_peak_bytes'] = int(peak)
        if trace:
            dev['busy_s'] = ctx['trace']['busy_s']
            dev['window_s'] = ctx['trace']['window_s']
        result['device'] = dev
        log(f'card: {smi_line}')
    else:
        result['device'] = dict(platform='cpu', kind='cpu', count=0, memory_peak_bytes=0)
    if trace:
        result['breakdown'] = dict(device_ops=ctx['trace']['device_ops'],
                                   idle_gaps=ctx['trace']['idle_gaps'])
    result['checks'] = {k: {'reading': v, 'limit': lim} for k, (v, lim) in table.items()}
    return result


def print_result(result, out=sys.stdout, err=sys.stderr):
    """The checks as the last lines on standard error, then the result line
    as the last line of standard output."""
    for k, v in result['checks'].items():
        print(f'check {k}: {v["reading"]!r} limit {v["limit"]!r}', file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
