"""Readings of the traced chunk that several per-layer metrics share (each
metric file under metrics/ names one of these as its `read`)."""


def device_ms_per_step(ctx):
    """Summed kernel device time (torch.profiler) over the profiled report
    chunk, its edges included, per step (ms)."""
    t = ctx.get('trace')
    if not t or t['n_kernels'] == 0:
        return None
    return 1e3 * t['kernel_s'] / t['steps']


def kernels_per_step(ctx):
    """Kernel launches on the device in the profiled chunk, per step."""
    t = ctx.get('trace')
    if not t or t['n_kernels'] == 0:
        return None
    return t['n_kernels'] / t['steps']


def device_idle(ctx):
    """Share (%) of the profiled chunk's span in which no operation ran on
    the device: 1 - the union of the device's operations / the span."""
    t = ctx.get('trace')
    if not t or t['busy_s'] <= 0:
        return None
    return 100.0 * (1.0 - t['busy_s'] / t['window_s'])


def ns_per_day(ctx):
    """Simulated ns per wall-clock day over the whole timed window: every
    step of its whole report chunks x dt over its wall time, the chunks'
    edges included."""
    w = ctx['window']
    return w['steps'] * w['dt_ps'] * 1e-3 / w['wall_s'] * 86400.0


def setup_s(ctx):
    """Seconds from process start to the first timed step."""
    return ctx['setup_s']
