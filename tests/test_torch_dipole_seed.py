"""The chunk's dipole seed taken from the last health check's converged
evaluation (md/simulation.py), on the CPU in float64: water3 in the MD
tests' 1.8 nm PME box, cutoff 0.85 nm, two steps a report interval.

(a) A run that reuses the health check's dipoles is bitwise equal
    (positions, velocities, box, per-step energies) to the same run with
    the kept dipoles dropped by hand before every chunk: NVE in one call
    of three intervals and in three calls of one, NPT with a barostat
    move inside every chunk, and scf='keep' on a SOR potential. Under the
    profiler the first run counts three seeds and two reuses, the second
    none.
(b) The counters: with check_health=False nothing is kept; an in-place
    edit of the state's positions, set_positions, load_checkpoint and
    minimize_energy give a miss and a fresh seed; two intervals in one
    call give two seeds, one reuse and three SCF solves.
(c) On a card at water256 (cuda-marked, skips here): after one chunk the
    kept dipoles equal a fresh converged evaluation's bit for bit.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fixtures
from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.system import (System, compute_virtual_sites,
                                                  make_molecules_whole)
from mbpol_openmm_plugin_tpu_torch.utils import tracing

torch.set_num_threads(1)

BOX = 1.8
R = 2          # steps a report interval

NPT = dict(temperature=300.0, thermostat='langevin', barostat_pressure=1.0,
           barostat_interval=1)
CASES = {
    'nve_one_call': (dict(), {}, [(3 * R, R)]),
    'nve_three_calls': (dict(), {}, [(R, R)] * 3),
    'npt_moves_in_every_chunk': (NPT, {}, [(3 * R, R)]),
    'scf_keep_sor': (dict(scf='keep'), dict(scf_method='sor'), [(3 * R, R)]),
}


def _sim(sim_cfg=None, pot_cfg=None):
    d = fixtures.load('water3')
    tsys = System.from_atom_names(d['names'], d['resnames'], box=[BOX] * 3)
    pot = MBPol(tsys, MBPolConfig.for_dynamics(cutoff=0.85, **(pot_cfg or {})), device='cpu')
    sim = Simulation(pot, SimulationConfig(dt=0.0002, **(sim_cfg or {})), seed=7)
    sim.set_positions(make_molecules_whole(tsys, torch.as_tensor(d['positions'])))
    sim.set_velocities_to_temperature(300.0)
    return sim


def _drop_before_every_chunk(sim):
    """The run without the reuse: the kept dipoles dropped by hand."""
    chunk = sim._chunk

    def dropped(state, n_steps):
        sim._kept_dipoles = None
        return chunk(state, n_steps)
    sim._chunk = dropped
    return sim


def _profiled(sim, calls, **kw):
    """(per-step total energies of the calls, the counters of the calls)."""
    tracing.reset()
    energies = []
    with profile(activities=[ProfilerActivity.CPU]):
        for n, interval in calls:
            energies.append(sim.step(n, report_interval=interval, **kw)['step_total_energy'])
    return np.concatenate(energies), tracing.counters()


def _assert_same_state(a, b):
    assert torch.equal(a.state.positions, b.state.positions)
    assert torch.equal(a.state.velocities, b.state.velocities)
    assert np.array_equal(np.asarray(a.state.box), np.asarray(b.state.box))
    assert a.state.step == b.state.step


@pytest.mark.parametrize('case', sorted(CASES))
def test_reuse_keeps_the_trajectory_bitwise(case):
    sim_cfg, pot_cfg, calls = CASES[case]
    reused = _sim(sim_cfg, pot_cfg)
    fresh = _drop_before_every_chunk(_sim(sim_cfg, pot_cfg))
    e_reused, c_reused = _profiled(reused, calls)
    e_fresh, c_fresh = _profiled(fresh, calls)
    assert np.array_equal(e_reused, e_fresh)
    _assert_same_state(reused, fresh)
    assert (c_reused['dipole_seeds'], c_reused.get('dipole_seed_reuses', 0)) == (3, 2)
    assert (c_fresh['dipole_seeds'], c_fresh.get('dipole_seed_reuses', 0)) == (3, 0)
    if case.startswith('npt'):
        assert c_reused['scf_solves'] == c_fresh['scf_solves'] - 2


def test_no_health_check_keeps_nothing():
    sim = _sim()
    _, c = _profiled(sim, [(3 * R, R)], check_health=False)
    assert sim._kept_dipoles is None
    assert c['dipole_seeds'] == 3 and 'dipole_seed_reuses' not in c


def test_positions_edited_in_place_miss():
    sim, ref = _sim(), _drop_before_every_chunk(_sim())
    for s in (sim, ref):
        s.step(R, report_interval=R)
        with torch.no_grad():
            s.state.positions[0, 0] += 1e-3
    e_sim, c = _profiled(sim, [(R, R)])
    e_ref, _ = _profiled(ref, [(R, R)])
    assert c['dipole_seeds'] == 1 and 'dipole_seed_reuses' not in c
    assert np.array_equal(e_sim, e_ref)
    _assert_same_state(sim, ref)


def _set_positions(sim):
    # the very tensor the health check evaluated: only the drop makes it a miss
    sim.set_positions(sim.state.positions)


def _load_checkpoint(sim):
    sim.load_checkpoint(sim.checkpoint())


def _minimize_energy(sim):
    sim.minimize_energy(max_iterations=2)


@pytest.mark.parametrize('replace', [_set_positions, _load_checkpoint, _minimize_energy],
                         ids=['set_positions', 'load_checkpoint', 'minimize_energy'])
def test_state_replaced_on_purpose_misses(replace):
    sim = _sim()
    sim.step(R, report_interval=R)
    assert sim._kept_dipoles is not None
    replace(sim)
    assert sim._kept_dipoles is None
    _, c = _profiled(sim, [(R, R)])
    assert c['dipole_seeds'] == 1 and 'dipole_seed_reuses' not in c


def test_two_intervals_in_one_call_count_one_reuse():
    sim = _sim()
    _, c = _profiled(sim, [(2 * R, R)])
    assert c['dipole_seeds'] == 2
    assert c['dipole_seed_reuses'] == 1
    assert c['scf_solves'] == 3


@pytest.mark.cuda
def test_kept_dipoles_are_a_fresh_evaluations_bits_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (the evaluation under test runs the card kernels)')
    d = fixtures.load('water256_integration_test')
    box = 19.3996888399961804 / 10.0
    tsys = System.from_atom_names(d['names'], d['resnames'], box=[box] * 3)
    pot = MBPol(tsys, MBPolConfig.for_dynamics(cutoff=0.9, electrostatics_mode='dense',
                                               dispersion_mode='dense'), device='cuda')
    sim = Simulation(pot, SimulationConfig(dt=0.0002, nlist_rebuild_interval='auto'), seed=7)
    pos = torch.as_tensor(d['positions'], dtype=torch.float32, device='cuda')
    sim.set_positions(compute_virtual_sites(tsys, make_molecules_whole(tsys, pos)))
    sim.set_velocities_to_temperature(300.0)
    sim.step(10, report_interval=10)
    (positions, _, _, kept_pot), kept = sim._kept_dipoles
    assert positions is sim.state.positions and kept_pot is pot
    fresh = pot._energy_forces_impl(sim.state.positions, box=sim.state.box)[3]
    assert torch.equal(kept, fresh['induced_dipoles'])
