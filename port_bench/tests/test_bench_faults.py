"""The run with its timed path broken underneath comes out not correct:
once for each fault an MD cell can have, and for an energy term left out.
(The exchange between chips does not exist in a one-chip cell.) The CPU
run of the same cell is correct."""
import pytest
import torch

from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation
from mbpol_openmm_plugin_tpu_torch.models import potential
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol

from ._cpu import cpu_run

WORKLOAD = 'water256_bulk.nve_r50'
_impl = MBPol._energy_forces_impl


def _state_unchanged(self, g):
    """A step that returns its state unchanged."""


def _half_left_out(self, *a, **k):
    """The forces of half of the waters left out."""
    e, f, parts, diag = _impl(self, *a, **k)
    f = f.clone()
    f[f.shape[0] // 2:] = 0.0
    return e, f, parts, diag


def _answer_altered(self, *a, **k):
    """One atom's force altered where it is produced (by a fifth of the
    largest force)."""
    e, f, parts, diag = _impl(self, *a, **k)
    f = f.clone()
    f[0, 0] += 0.2 * torch.max(torch.abs(f))
    return e, f, parts, diag


def _term_left_out(system, pos, *a, **k):
    """The dispersion term (energy and forces, ~1-2% of the largest force)
    left out of the potential."""
    return 0.0 * torch.sum(pos)


FAULTS = {'state_unchanged': (Simulation, '_body', _state_unchanged),
          'half_left_out': (MBPol, '_energy_forces_impl', _half_left_out),
          'answer_altered': (MBPol, '_energy_forces_impl', _answer_altered),
          'term_left_out': (potential, 'dispersion_energy', _term_left_out)}


def test_sound_run_is_correct():
    assert cpu_run(WORKLOAD)[1]['correct'] is True


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    cls, name, fn = FAULTS[fault]
    monkeypatch.setattr(cls, name, fn)
    result, line, _ = cpu_run(WORKLOAD)
    assert line['correct'] is False, line['checks']
