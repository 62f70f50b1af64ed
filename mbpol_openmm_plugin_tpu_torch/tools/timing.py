"""Times and bounds on one CUDA card, shared by chip_smoke.py and the
probes of this folder.

- `card_line`: the card's name and power limit as nvidia-smi prints them,
  to stand beside every time;
- `loop_ms`, `median_ms`: CUDA-event times of back-to-back calls and of
  synchronized calls;
- `kernel_device_ms`: device time per launch of one CUDA kernel (and of
  the helper kernels launched with it) from torch.profiler's trace,
  divided by the launches of that kernel the trace holds;
- `bound`: the least time the card could take for a given work, from the
  H100 SXM peaks below.
"""
from __future__ import annotations

import subprocess
from collections import namedtuple

import numpy as np
import torch

# H100 SXM peaks: HBM bytes/s, fp32 FLOP/s on the CUDA cores, dense bf16
# FLOP/s on the tensor cores, transcendental results per clock per SM
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12
MUFU_PER_CLOCK_PER_SM = 16

DeviceTime = namedtuple('DeviceTime', 'ms kernel_ms helper_ms launches each')


def _smi(query):
    out = subprocess.run(['nvidia-smi', f'--query-gpu={query}', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card_line():
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    return _smi('name,power.limit')


def max_sm_clock_hz():
    return float(_smi('clocks.max.sm').split()[0]) * 1e6


def transcendental_rate():
    """Results per second of the transcendental unit: MUFU_PER_CLOCK_PER_SM
    per clock per SM at the card's maximum SM clock."""
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    return MUFU_PER_CLOCK_PER_SM * n_sms * max_sm_clock_hz()


def bound(n_bytes, n_ops, n_tensor_ops=0, tensor_scheme=None, n_transcendental=0,
          transcendental_rate=None):
    """(least time in ms the card could take, what bounds it): the largest
    of bytes over HBM_BPS ('bytes'); the CUDA-core operations over
    FP32_FLOPS ('operations'); for a tensor-core kernel, the bf16 operations
    of its passes over BF16_TENSOR_FLOPS ('operations (<scheme>)'); and,
    where given, the transcendentals over the transcendental unit's results
    per second ('operations (transcendentals)'). The units run side by side,
    so their times are not added."""
    times = {'bytes': n_bytes / HBM_BPS, 'operations': n_ops / FP32_FLOPS}
    if n_tensor_ops:
        times[f'operations ({tensor_scheme})'] = n_tensor_ops / BF16_TENSOR_FLOPS
    if n_transcendental:
        times['operations (transcendentals)'] = n_transcendental / transcendental_rate
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def loop_ms(fn, n):
    """Mean time per call of n back-to-back calls between two CUDA events
    (one synchronize at the end): device time once the device, not the
    host, is the slower of the two."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def median_ms(fn, n):
    """Median of n calls, each between two CUDA events and followed by a
    synchronize: the wrapper call, host work included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _short(key):
    return key.replace('(anonymous namespace)::', '').split('(')[0].split('<')[0][-40:]


def kernel_device_ms(fn, kernel, n, helpers=()):
    """Device time per launch of the CUDA kernel whose name contains
    `kernel`, over n calls of fn, from torch.profiler's device trace, as
    DeviceTime(ms: the kernel's plus the `helpers` kernels' fn launches
    with it, kernel_ms, helper_ms, launches: those of `kernel` in the
    trace, each: {kernel name: device ms} of every kernel in the trace).
    Every time is a total divided by `launches`, not by n, so a trace that
    lost events does not read low; ms is None when the trace holds no
    device time for the kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    own_us, helper_us, launches, every = 0.0, 0.0, 0, {}
    for ev in prof.key_averages():
        if ev.device_time_total <= 0:
            continue
        every[_short(ev.key)] = every.get(_short(ev.key), 0.0) + ev.device_time_total
        if kernel in ev.key:
            own_us += ev.device_time_total
            launches += ev.count
        elif any(h in ev.key for h in helpers):
            helper_us += ev.device_time_total
    if not (launches and own_us > 0):
        return DeviceTime(None, None, None, launches, {})
    per = 1e3 * launches
    return DeviceTime((own_us + helper_us) / per, own_us / per, helper_us / per, launches,
                      {k: v / per for k, v in every.items()})
