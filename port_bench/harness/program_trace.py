"""Readings of the program's own spans, counters and set-up phases
(mbpol_openmm_plugin_tpu_torch/utils/tracing.py) that the per-layer
metrics share.

The spans come with the profiled chunk (trace.py keeps the host time of
every span named md.* or models.*, the program's as well as the
benchmark's, in ctx['trace']['span_s']). The counters and the phases are
read from the program's tracing module: it counts only while a profiler
records, so its counters are those of the one profiled chunk, and it keeps
the set-up phases' host times whether profiled or not. Besides sut.py this
is the one module of the benchmark that imports the program, and it
imports only utils/tracing. Every reader returns None where the program
has no such span, counter or phase, as a program without the tracing
module has none."""

EDGE_SPANS = ('md.simulation.dipole_seed', 'md.simulation.readback',
              'md.simulation.health_check')
REPLAY_SPAN = 'md.step_graph.replay'


def program():
    """(counters, phases) of the program's tracing module, or None where
    the program has no tracing module."""
    try:
        from mbpol_openmm_plugin_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.counters(), tracing.phases()


def _spans(ctx):
    t = ctx.get('trace')
    return (t or {}).get('span_s') or {}


def _counters(ctx):
    """The profiled chunk's counters, or None without a profiled chunk or a
    tracing module."""
    prog = program()
    if not ctx.get('trace') or prog is None:
        return None
    return prog[0]


def _first(name):
    prog = program()
    if prog is None or name not in prog[1]:
        return None
    return prog[1][name]['first_s']


def edge_host_share(ctx):
    """Share (%) of the profiled chunk's span that the host spends at the
    report edges: the dipole seed's converged evaluation, the readbacks
    and the health check (the program's spans), summed."""
    spans = _spans(ctx)
    found = [spans[s] for s in EDGE_SPANS if s in spans]
    if not found or not ctx['trace'].get('window_s'):
        return None
    return 100.0 * sum(found) / ctx['trace']['window_s']


def replay_host_ms_per_step(ctx):
    """Host ms in the CUDA graph replays (the span around each
    graph.replay()) per step of the profiled chunk."""
    spans = _spans(ctx)
    if REPLAY_SPAN not in spans or not ctx['trace'].get('steps'):
        return None
    return 1e3 * spans[REPLAY_SPAN] / ctx['trace']['steps']


def host_reads_per_chunk(ctx):
    """Reads of device values on the host in the profiled chunk."""
    c = _counters(ctx)
    return None if c is None or 'host_reads' not in c else c['host_reads']


def scf_iterations_per_solve(ctx):
    """SOR (or DIIS) iterations per converged solve in the profiled chunk."""
    c = _counters(ctx)
    if c is None or not c.get('scf_solves'):
        return None
    return c['scf_iterations'] / c['scf_solves']


def setup_capture_s(ctx):
    """Host seconds of the set-up's first eager step at a box and of its
    capture into a CUDA graph."""
    eager, capture = _first('md.step_graph.eager_step'), _first('md.step_graph.capture')
    return None if eager is None or capture is None else eager + capture


def setup_first_eval_s(ctx):
    """Host seconds of the set-up's first converged evaluation
    (Simulation.set_positions)."""
    return _first('md.simulation.set_positions')
