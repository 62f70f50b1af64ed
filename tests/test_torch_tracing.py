"""The port's spans and counters (utils/tracing.py) on the CPU, float64:
water3 in the MD tests' 1.8 nm PME box, cutoff 0.85 nm, two steps a run.

(a) With no profiler, `span` returns the shared no-op and no
    record_function runs (it is made to raise) through a Simulation.step;
    the counters do not move; the set-up phases fill.
(b) Under torch.profiler (CPU activity), an NVE step with the health
    check: md.simulation.chunk holds the dipole seed, the readbacks, the
    health check and the SCF stop tests; scf_solves is the chunk's two
    converged evaluations, scf_iterations the sum of their
    diag['iterations'], host_reads at least scf_iterations + 3.
(c) Under a barostat, a move (md.simulation.barostat_move) holds two
    md.simulation.barostat_trial and reads its uniforms and energies.
(d) Positions and velocities after the steps are bitwise equal with the
    profiler on and off.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fixtures
from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.system import System, make_molecules_whole
from mbpol_openmm_plugin_tpu_torch.utils import tracing

torch.set_num_threads(1)

BOX = 1.8
STEPS = 2


def _sim(**cfg):
    d = fixtures.load('water3')
    tsys = System.from_atom_names(d['names'], d['resnames'], box=[BOX] * 3)
    sim = Simulation(MBPol(tsys, MBPolConfig.for_dynamics(cutoff=0.85), device='cpu'),
                     SimulationConfig(dt=0.0002, **cfg), seed=7)
    sim.set_positions(make_molecules_whole(tsys, torch.as_tensor(d['positions'])))
    sim.set_velocities_to_temperature(300.0)
    return sim


def _spans(prof):
    """[(name, start ns, end ns)] of the program's spans in a profile."""
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.name().startswith(('md.', 'models.'))]


def _inside(spans, outer, inner):
    """The `inner` spans that lie within some `outer` span."""
    outs = [(a, b) for n, a, b in spans if n == outer]
    return [(a, b) for n, a, b in spans if n == inner
            and any(oa <= a and b <= ob for oa, ob in outs)]


@pytest.fixture(scope='module')
def runs():
    """The same NVE start stepped without and with the profiler."""
    tracing.reset()
    quiet = _sim()
    phases = tracing.phases()
    with pytest.MonkeyPatch.context() as m:
        def refuse(name):
            raise AssertionError(f'record_function({name!r}) ran with no profiler')
        m.setattr(tracing, 'record_function', refuse)
        noop = tracing.span('md.simulation.chunk')
        quiet.step(STEPS)
    quiet_counters = tracing.counters()

    traced = _sim()
    iterations = []
    impl = traced.potential._energy_forces_impl

    def converged(p, mu0=None, **kw):
        out = impl(p, mu0, **kw)
        if mu0 is None:
            iterations.append(int(out[3]['iterations']))
        return out
    traced.potential._energy_forces_impl = converged
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced.step(STEPS)
    return dict(quiet=quiet, noop=noop, phases=phases, quiet_counters=quiet_counters,
                traced=traced, counters=tracing.counters(), spans=_spans(prof),
                iterations=iterations)


def test_no_profiler_no_spans_no_counts(runs):
    assert runs['noop'] is tracing.NO_SPAN
    assert runs['quiet_counters'] == {}
    for name in ('models.potential.init', 'md.simulation.set_positions'):
        p = runs['phases'][name]
        assert p['count'] == 1 and 0 < p['first_s'] == p['total_s']


def test_traced_chunk_spans_and_counters(runs):
    spans, c = runs['spans'], runs['counters']
    assert sum(n == 'md.simulation.chunk' for n, _, _ in spans) == 1
    for inner in ('md.simulation.dipole_seed', 'md.simulation.readback',
                  'md.simulation.health_check', 'models.electrostatics.scf_stop_test'):
        assert _inside(spans, 'md.simulation.chunk', inner), inner
    assert len(runs['iterations']) == 2 == c['scf_solves']
    assert c['scf_iterations'] == sum(runs['iterations'])
    assert len(_inside(spans, 'models.electrostatics.scf',
                       'models.electrostatics.scf_stop_test')) == c['scf_iterations']
    assert c['host_reads'] >= c['scf_iterations'] + 3


def test_barostat_move_holds_two_trials():
    sim = _sim(temperature=300.0, thermostat='langevin', barostat_pressure=1.0,
               barostat_interval=1)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = sim.step(1, check_health=False)
    spans = _spans(prof)
    assert out['barostat_attempted'] == 1
    assert sum(n == 'md.simulation.barostat_move' for n, _, _ in spans) == 1
    assert len(_inside(spans, 'md.simulation.barostat_move',
                       'md.simulation.barostat_trial')) == 2
    assert tracing.counters()['host_reads'] >= 2


def test_profiler_leaves_the_trajectory_bitwise(runs):
    q, t = runs['quiet'].state, runs['traced'].state
    assert torch.equal(q.positions, t.positions)
    assert torch.equal(q.velocities, t.velocities)
    assert np.array_equal(q.box, t.box)
