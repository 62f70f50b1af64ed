"""examples/isotope_density.py's pipeline on the port
(mbpol_openmm_plugin_tpu_torch/examples/isotope_density.py) against the
JAX package's, CPU float64 (a file of its own: the JAX NPT ring-polymer
chunk compiles once per isotopologue).

- D2O and H2O water50 (box 1.8 nm, cutoff 0.85 nm), 2 -> 1 beads, a volume
  move every 2 steps, 4 steps (isotope_density.py:70-85), PIMDSimulation
  fed the JAX draws (as test_torch_rpmd.py does): the report rows' volumes
  and the densities 1e-12 relative, the moves attempted; an accepted JAX
  move keeps the forces of the old positions and box (the reference's
  fault, ROADMAP section 3; the port's carries the trial's), so after the
  first one the trajectories part: KE_cv within 1e-6 relative, positions
  within 1e-5 nm and not within 1e-10 (the gap is asserted and printed).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu.md import rpmd as JR
from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
from mbpol_openmm_plugin_tpu.system import System as JSystem
from mbpol_openmm_plugin_tpu.system import compute_virtual_sites as jvsites
from mbpol_openmm_plugin_tpu.system import make_molecules_whole as jwhole
from mbpol_openmm_plugin_tpu_torch.examples import isotope_density
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPolConfig
from test_torch_rpmd import _feed_jax_draws

torch.set_num_threads(1)

BOX50 = 1.8
W50 = dict(nonbonded_method='PME', cutoff=0.85, target_epsilon=1e-3, max_iterations=200,
           nlist_skin=0.02)


@pytest.fixture(scope='module')
def water50():
    """(names, resnames, whole positions with the M sites placed) of water50
    in its 1.8 nm box."""
    d = fixtures.load('water50')
    jsys = JSystem.from_atom_names(d['names'], d['resnames'], box=[BOX50] * 3)
    pos = np.asarray(jvsites(jsys, jwhole(jsys, jnp.asarray(d['positions']))))
    return d['names'], d['resnames'], pos


@pytest.mark.parametrize('isotope', ['D2O', 'H2O'])
def test_isotope_density_matches_jax(water50, isotope):
    names, resnames, pos = water50
    box = [BOX50] * 3
    n, interval, steps = 2, 2, 4
    seed = isotope_density.SEEDS[isotope]
    jsys = JSystem.waters(50, box=box, isotope=isotope)
    jpot = JMBPol(jsys, JConfig(**W50))
    jpot.tune_capacities(jnp.asarray(pos))
    jsim = JR.PIMDSimulation(jpot, n, dt=isotope_density.DT, temperature=isotope_density.T,
                             tau0=0.1, contraction=1, barostat_pressure=isotope_density.P_BAR,
                             barostat_interval=interval, seed=seed)
    jsim.set_positions(jnp.asarray(pos), box=box, spread=0.002)
    report = isotope_density.report_interval(steps, interval)
    jrows = jsim.step(steps, report_interval=report)

    sim, tpos, _ = isotope_density.simulation(isotope, n, interval, device='cpu', positions=pos,
                                              box=box, config=MBPolConfig(**W50))
    _feed_jax_draws(sim, seed)
    sim.set_positions(tpos, box=box, spread=0.002)
    out = isotope_density.run_one(isotope, n, steps, interval, sim=sim, echo=False)
    vols = np.asarray(jrows['volume'])
    assert out['volumes'].shape == vols.shape == (steps // report,)
    np.testing.assert_allclose(out['volumes'], vols, rtol=1e-12)
    assert out['moves_attempted'] == steps // interval
    rho = float(np.sum(jsys.masses)) * isotope_density.AMU_PER_NM3_TO_G_CM3 / vols
    assert abs(out['rho'] - rho[len(rho) // 2:].mean()) <= 1e-12 * out['rho']
    assert out['moves_accepted'] >= 1 and np.all(vols != np.prod(box))
    # an accepted JAX move keeps the pre-move forces (ROADMAP section 3), the
    # port's carries the trial's: the trajectories part there, by far less
    # than the bounds below, and the gap shows
    ke = float(np.mean(jrows['kinetic_virial'][len(vols) // 2:]))
    assert abs(out['ke_virial_kj'] - ke) <= 1e-6 * abs(ke)
    gap = float(np.max(np.abs(sim.state.positions.numpy() - np.asarray(jsim.state.positions))))
    print(f'{isotope}: positions {gap:.3e} nm from the JAX run after its stale-force move')
    assert 1e-10 < gap <= 1e-5
