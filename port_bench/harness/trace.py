"""One report chunk under torch.profiler, reduced to what the per-layer
metrics and the result line read: device busy time (the union of the
device's operations), kernel time and launches by name, the host's time
in each benchmark span, and the idle gaps labelled by the innermost
benchmark span the host was in. The kineto
events are read as they come (no FunctionEvent tree is built: a chunk at
water256 holds ~1.8 M kernels). No trace file is written."""
import time

import numpy as np
import torch

SPAN_PREFIXES = ('bench.', 'models.', 'md.')
NOT_KERNELS = ('Memcpy', 'Memset', 'memcpy', 'memset')


def profile_chunk(run):
    """Profile one report chunk of `run` (sut.Run); returns the reduction."""
    from torch.profiler import ProfilerActivity, profile, record_function
    run.wrap_spans(record_function)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function('bench.chunk'):
            t0 = time.perf_counter()
            steps = run.chunk()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    out = reduce_events(prof.profiler.kineto_results.events(), steps, wall)
    out['reduce_s'] = time.perf_counter() - t1
    return out


def _short(name, n=96):
    return name.replace('(anonymous namespace)::', '').split('(')[0][:n]


def reduce_events(events, steps, wall):
    """The profile's kineto events (torch._C._autograd._KinetoEvent: name(),
    device_type(), start_ns(), end_ns(), is_user_annotation()); times in
    ns. The device's copies of the benchmark's spans (user annotations) are
    spans, not device work."""
    from torch.autograd import DeviceType
    dev_start, dev_end, by_name, spans, span_s = [], [], {}, [], {}
    n_kernels = 0
    chunk = None
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            s, t = e.start_ns(), e.end_ns()
            dev_start.append(s)
            dev_end.append(t)
            name = _short(name)
            tot, cnt = by_name.get(name, (0.0, 0))
            by_name[name] = (tot + (t - s) * 1e-9, cnt + 1)
            if not name.startswith(NOT_KERNELS):
                n_kernels += 1
        elif e.device_type() == DeviceType.CPU and name.startswith(SPAN_PREFIXES):
            spans.append((e.start_ns(), e.end_ns(), name))
            span_s[name] = span_s.get(name, 0.0) + (e.end_ns() - e.start_ns()) * 1e-9
            if name == 'bench.chunk':
                chunk = (e.start_ns(), e.end_ns())
    if not dev_start or chunk is None:
        return dict(steps=steps, wall_s=wall, busy_s=0.0, kernel_s=0.0, n_kernels=0,
                    kernels={}, span_s=span_s, device_ops=[], idle_gaps=[])
    s = np.asarray(dev_start)
    t = np.asarray(dev_end)
    order = np.argsort(s)
    s, t = s[order], t[order]
    reach = np.maximum.accumulate(t)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    starts = s[new]
    ends = np.append(reach[np.nonzero(new)[0][1:] - 1], reach[-1])
    busy = float(np.sum(ends - starts)) * 1e-9
    gap_lo = np.concatenate([[chunk[0]], ends])
    gap_hi = np.concatenate([starts, [chunk[1]]])
    gaps = np.clip(gap_hi, chunk[0], chunk[1]) - np.clip(gap_lo, chunk[0], chunk[1])
    top = np.argsort(gaps)[::-1][:10]
    spans.sort(key=lambda x: x[1] - x[0])

    def label(mid):
        for a, b, name in spans:      # shortest (innermost) first
            if a <= mid <= b:
                return name
        return 'host outside the spans'

    idle = [[label(0.5 * (gap_lo[i] + gap_hi[i])), float(gaps[i]) * 1e-9]
            for i in top if gaps[i] > 0]
    kernel_s = sum(v[0] for k, v in by_name.items() if not k.startswith(NOT_KERNELS))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(steps=steps, wall_s=wall, window_s=float(chunk[1] - chunk[0]) * 1e-9,
                busy_s=busy, kernel_s=kernel_s, n_kernels=n_kernels, kernels=by_name,
                span_s=span_s, device_ops=[[k, v[0]] for k, v in ops], idle_gaps=idle)


def kernel_group(kernels, fragments):
    """{fragment: (device seconds, launches)} summed over the kernels whose
    names contain each fragment."""
    out = {}
    for frag in fragments:
        hits = [v for k, v in kernels.items() if frag in k]
        out[frag] = (sum(h[0] for h in hits), sum(h[1] for h in hits))
    return out
