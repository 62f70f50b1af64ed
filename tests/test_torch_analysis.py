"""The port's analysis.py against the JAX package's: every function on the
same seeded numpy inputs (over each package's own System) within 1e-12,
and dipole_series on water3 (the port's CPU float64 system moments against
the JAX ones) within 1e-8 Debye.
"""
import jax
import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu import analysis as janalysis
from mbpol_openmm_plugin_tpu.models import electrostatics as jelec
from mbpol_openmm_plugin_tpu.system import System as JSystem
from mbpol_openmm_plugin_tpu_torch import analysis
from mbpol_openmm_plugin_tpu_torch.system import System

torch.set_num_threads(1)

N_WATERS, BOX, N_FRAMES = 16, 1.2, 32
TEMPS = np.array([280.0, 300.0, 325.0])


def _inputs(periodic):
    """(frames, velocities, dipoles, energies) from a seed: waters of a
    periodic box (or a cluster) with bonded geometry jittered per frame."""
    rng = np.random.default_rng(7)
    o = rng.uniform(0.0, BOX, size=(N_WATERS, 3))
    h1 = o + np.array([0.0957, 0.0, 0.0])
    h2 = o + np.array([-0.024, 0.0927, 0.0])
    base = np.stack([o, h1, h2, (o + h1 + h2) / 3.0], axis=1).reshape(-1, 3)
    drift = np.cumsum(rng.normal(0.0, 0.02, size=(N_FRAMES, 1, 3)), axis=0)
    frames = base[None] + drift + rng.normal(0.0, 0.003, size=(N_FRAMES, 4 * N_WATERS, 3))
    if periodic:
        frames = frames - np.floor(frames / BOX) * BOX
    vel = rng.normal(0.0, 0.5, size=(N_FRAMES, 4 * N_WATERS, 3))
    dipoles = rng.normal(0.0, 2.0, size=(N_FRAMES, 3))
    energies = -400.0 + 2.0 * TEMPS[:, None] * 0.1 + rng.normal(0.0, 3.0, size=(3, 200))
    return frames, vel, dipoles, energies


# name -> (periodic, call(module, system, inputs))
CASES = {
    'radial_distribution_OO': (True, lambda m, s, x: m.radial_distribution(s, x[0], n_bins=30)),
    'radial_distribution_OH_cluster': (False, lambda m, s, x: m.radial_distribution(
        s, x[0], n_bins=30, species='OH')),
    'velocity_autocorrelation': (True, lambda m, s, x: m.velocity_autocorrelation(s, x[1])),
    'vibrational_density_of_states_H': (True, lambda m, s, x: m.vibrational_density_of_states(
        s, x[1], 1e-3, species='H')),
    'unwrap_trajectory': (True, lambda m, s, x: m.unwrap_trajectory(x[0], np.full(3, BOX))),
    'mean_squared_displacement': (True, lambda m, s, x: m.mean_squared_displacement(
        s, x[0], 0.01)),
    'mean_squared_displacement_O': (True, lambda m, s, x: m.mean_squared_displacement(
        s, x[0], 0.01, species='O', remove_system_com=False)),
    'diffusion_coefficient_gk': (True, lambda m, s, x: m.diffusion_coefficient_gk(
        s, x[1], 0.01, max_lag=10)),
    'diffusion_coefficient': (True, lambda m, s, x: m.diffusion_coefficient(
        *m.mean_squared_displacement(s, x[0], 0.01))),
    'static_dielectric': (True, lambda m, s, x: m.static_dielectric(x[2], BOX ** 3, 300.0)),
    'infrared_spectrum': (True, lambda m, s, x: m.infrared_spectrum(x[2], 1e-3)),
    'mbar_free_energies': (True, lambda m, s, x: m.mbar_free_energies(x[3], TEMPS)),
    'mbar_reweight': (True, lambda m, s, x: m.mbar_reweight(
        x[3], TEMPS, 310.0, observable=x[3] ** 2)),
    'mbar_heat_capacity': (True, lambda m, s, x: m.mbar_heat_capacity(
        x[3], TEMPS, target_temperatures=[290.0, 310.0])),
    'static_structure_factor': (True, lambda m, s, x: m.static_structure_factor(
        s, x[0], q_max=20.0, n_bins=20)),
    'hydrogen_bonds': (True, lambda m, s, x: m.hydrogen_bonds(s, x[0], r_oo_max=0.5,
                                                               angle_max_deg=60.0)),
    'tetrahedral_order_cluster': (False, lambda m, s, x: m.tetrahedral_order(s, x[0])),
}


def _flatten(out):
    if isinstance(out, dict):
        return [np.asarray(out[k], np.float64) for k in sorted(out)]
    if isinstance(out, tuple):
        return [np.asarray(o, np.float64) for o in out]
    return [np.asarray(out, np.float64)]


@pytest.mark.parametrize('name', sorted(CASES))
def test_analysis_matches_jax(name):
    periodic, call = CASES[name]
    box = [BOX] * 3 if periodic else None
    x = _inputs(periodic)
    ours = _flatten(call(analysis, System.waters(N_WATERS, box=box), x))
    ref = _flatten(call(janalysis, JSystem.waters(N_WATERS, box=box), x))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * max(1.0, np.max(np.abs(b))))


def test_dipole_series_matches_jax(monkeypatch):
    """dipole_series through the port's system_moments (CPU float64) against
    the JAX package's, three frames of water3 (the fixture and two
    displacements), within 1e-8 Debye. The JAX system_moments runs as one
    compiled program over the frame (it evaluates op by op otherwise,
    several times slower to compile)."""
    moments = jelec.system_moments
    monkeypatch.setattr(jelec, 'system_moments', lambda params, pos, masses: jax.jit(
        lambda p: moments(params, p, masses))(pos))
    from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
    from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig

    d = fixtures.load('water3')
    jsys, jpos = fixtures.load_system('water3')
    rng = np.random.default_rng(3)
    frames = np.asarray(jpos)[None] + np.concatenate(
        [np.zeros((1,) + jpos.shape), rng.normal(0.0, 0.002, size=(2,) + jpos.shape)])
    ref = janalysis.dipole_series(JMBPol(jsys, JConfig(nonbonded_method='NoCutoff')), frames)
    pot = MBPol(System.from_atom_names(d['names'], d['resnames']),
                MBPolConfig(nonbonded_method='NoCutoff'), device='cpu')
    ours = analysis.dipole_series(pot, frames)
    assert ours.shape == (3, 3)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-8)
    assert np.max(np.abs(ours[1:] - ours[:1])) > 1e-4       # the frames differ
