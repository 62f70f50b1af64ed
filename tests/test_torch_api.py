"""The port's per-force API (api.py) and MBPol.with_updated_params against
the JAX package's, CPU float64: the four Forces on water3 and water14
(electrostatics under NoCutoff and PME) within 1e-8 relative, the system
moments and the grid potential within 1e-8, and tests/test_api.py's
mid-run parameter update on the port with each updated potential's
energies against the JAX with_updated_params within 1e-10.
"""
import jax
import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu import api as japi
from mbpol_openmm_plugin_tpu.models import electrostatics as jelec
from mbpol_openmm_plugin_tpu.models import pme as jpme
from mbpol_openmm_plugin_tpu_torch import _data, api

torch.set_num_threads(1)

REL = 1e-8
PME_BOX = [1.8] * 3
KINDS = ('one_body', 'two_body', 'three_body', 'electrostatics_nocutoff',
         'electrostatics_pme')


@pytest.fixture
def jit_jax(monkeypatch):
    """The JAX Forces evaluate op by op; each of their evaluations runs here
    as one compiled program instead (the same functions, jax.jit over the
    positions), which compiles several times faster."""
    vg = jax.value_and_grad
    monkeypatch.setattr(jax, 'value_and_grad', lambda f: jax.jit(vg(f)))
    for mod, name in ((jelec, 'cluster_electrostatics'), (jelec, 'system_moments'),
                      (jelec, 'electrostatic_potential_on_grid'), (jpme, 'pme_electrostatics')):
        fn = getattr(mod, name)

        def compiled(params, *args, _fn=fn):
            traced = [i for i, a in enumerate(args) if isinstance(a, jax.Array)]

            def program(*values):
                full = list(args)
                for i, v in zip(traced, values):
                    full[i] = v
                return _fn(params, *full)
            return jax.jit(program)(*(args[i] for i in traced))

        monkeypatch.setattr(mod, name, compiled)


def _positions(name):
    """[natoms, 3] nm with the M sites placed (the JAX placement)."""
    return np.asarray(fixtures.load_system(name)[1])


def _force(mod, kind, n_waters, **kw):
    """A Force of module `mod` (the port's api or the JAX one) over n_waters
    stride-4 OHHM waters with the force field's per-site parameters."""
    if kind == 'one_body':
        f = mod.MBPolOneBodyForce(**kw)
        add = f.addOneBody
    elif kind == 'two_body':
        f = mod.MBPolTwoBodyForce(**kw)
        add = f.addParticle
    elif kind == 'three_body':
        f = mod.MBPolThreeBodyForce(**kw)
        add = f.addParticle
    else:
        f = mod.MBPolElectrostaticsForce(**kw)
        ff = _data.load('forcefield')
        for mol in range(n_waters):
            for t, key in ((0, 'atom_O'), (1, 'atom_H'), (1, 'atom_H'), (2, 'atom_M')):
                q, damp, pol = (float(x) for x in ff[key])
                f.addElectrostatics(q, mol, t, damp, pol)
        if kind == 'electrostatics_pme':
            f.setNonbondedMethod(mod.MBPolElectrostaticsForce.PME)
            f.setPeriodicBox(PME_BOX)
        f.setMutualInducedTargetEpsilon(1e-10)
        f.setMutualInducedMaxIterations(500)
        return f
    for mol in range(n_waters):
        add([4 * mol, 4 * mol + 1, 4 * mol + 2])
    return f


@pytest.mark.parametrize('name', ['water3', 'water14'])
@pytest.mark.parametrize('kind', KINDS)
def test_force_matches_jax(kind, name, jit_jax):
    pos = _positions(name)
    n_waters = len(pos) // 4
    e, f = _force(api, kind, n_waters, device='cpu').computeForceAndEnergy(pos)
    e_ref, f_ref = _force(japi, kind, n_waters).computeForceAndEnergy(pos)
    f_ref = np.asarray(f_ref)
    assert f.shape == f_ref.shape == pos.shape
    assert abs(e - e_ref) <= REL * abs(e_ref), (e, e_ref)
    np.testing.assert_allclose(f, f_ref, rtol=0, atol=REL * np.max(np.abs(f_ref)))


def _three_site(mod, **kw):
    """test_api.py's 3-site water3 electrostatics force (no redistribution)."""
    f = mod.MBPolElectrostaticsForce(**kw)
    for mol in range(3):
        f.addElectrostatics(-5.1966000e-01, mol, 0, 0.001310, 0.001310)
        f.addElectrostatics(2.5983000e-01, mol, 1, 0.000294, 0.000294)
        f.addElectrostatics(2.5983000e-01, mol, 1, 0.000294, 0.000294)
    f.setTholeParameters([0.4] * 5)
    f.setIncludeChargeRedistribution(False)
    f.setMutualInducedTargetEpsilon(1e-10)
    return f


def test_moments_and_grid_potential_match_jax(jit_jax):
    """getSystemElectrostaticsMoments and getElectrostaticPotential on the
    3-site water3 (test_api.py's golden energy too) and on the 4-site
    water3 with charge redistribution."""
    from test_electrostatics_cluster import WATER3_POS9
    grid = np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [-0.3, 0.2, 0.5]])
    pos4 = _positions('water3')
    cases = ((_three_site(api, device='cpu'), _three_site(japi), WATER3_POS9,
              np.tile([15.999, 1.008, 1.008], 3)),
             (_force(api, 'electrostatics_nocutoff', 3, device='cpu'),
              _force(japi, 'electrostatics_nocutoff', 3), pos4,
              np.tile([15.999, 1.008, 1.008, 0.0], 3)))
    e3, _ = cases[0][0].computeForceAndEnergy(WATER3_POS9)
    assert abs(e3 / 4.184 - (-7.08652)) < 1e-3, e3 / 4.184
    for ours, ref, pos, masses in cases:
        m = ours.getSystemElectrostaticsMoments(masses, pos)
        m_ref = np.asarray(ref.getSystemElectrostaticsMoments(masses, pos))
        assert m.shape == (13,) and abs(m[0]) < 1e-10
        np.testing.assert_allclose(m, m_ref, rtol=0, atol=REL * np.max(np.abs(m_ref)))
        p = ours.getElectrostaticPotential(grid, pos)
        p_ref = np.asarray(ref.getElectrostaticPotential(grid, pos))
        assert p.shape == (3,)
        np.testing.assert_allclose(p, p_ref, rtol=REL)


def test_getters_setters_and_device():
    f = api.MBPolElectrostaticsForce(device='cpu')
    f.addElectrostatics(-0.5, 0, 0, 0.001, 0.001)
    f.setElectrostaticsParameters(0, -0.4, 0, 0, 0.002, 0.003)
    assert f.getElectrostaticsParameters(0) == (-0.4, 0, 0, 0.002, 0.003)
    f.setCutoffDistance(0.8)
    f.setAEwald(3.0)
    f.setPmeGridDimensions([10, 11, 12])
    f.setEwaldErrorTolerance(1e-5)
    assert (f.getCutoffDistance(), f.getAEwald(), f.getPmeGridDimensions(),
            f.getEwaldErrorTolerance(), f.getNumElectrostatics()) == (0.8, 3.0, [10, 11, 12],
                                                                    1e-5, 1)
    t = _force(api, 'two_body', 2, device='cpu')
    assert t.getParticleParameters(1) == [4, 5, 6] and t.getNumMolecules() == 2
    o = api.MBPolOneBodyForce(device='cpu')
    o.addOneBody([0, 1, 2])
    o.setOneBodyParameters(0, [4, 5, 6])
    assert o.getOneBodyParameters(0) == [4, 5, 6]
    # the default device is the card: without one, a Force raises
    for cls in (api.MBPolOneBodyForce, api.MBPolTwoBodyForce, api.MBPolThreeBodyForce,
                api.MBPolElectrostaticsForce):
        if torch.cuda.is_available():
            assert cls().device.type == 'cuda'
        else:
            with pytest.raises(RuntimeError, match='no CUDA device'):
                cls()


def test_with_updated_params_midrun(jit_jax):
    """tests/test_api.py's mid-run update on the port: thole and charges
    mutated on a live potential, capacities carried over, a particle-count
    mismatch raising, the round trip exact; each updated potential's
    electrostatics energy (the term its parameters enter) against the JAX
    cluster_electrostatics (compiled) over the JAX with_updated_params' parameters
    within 1e-10 relative, and with_updated_params(thole=...) bit for bit a
    fresh MBPol built with that thole."""
    from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
    from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.system import System

    d = fixtures.load('water3')
    jsys, jpos = fixtures.load_system('water3')
    pos = np.asarray(jpos)
    jpot = JMBPol(jsys, JConfig(nonbonded_method='NoCutoff'))
    pot = MBPol(System.from_atom_names(d['names'], d['resnames']),
                MBPolConfig(nonbonded_method='NoCutoff'), device='cpu')

    def energies(p):
        e, f, parts, _ = p.energy_forces(pos)
        return float(e), float(parts['electrostatics']), float(parts['two_body']), f

    def check(p, jp):
        # the electrostatics, the term the parameters enter, against the
        # JAX function on the JAX potential's updated parameters
        _, e_el, _, _ = energies(p)
        je = float(jelec.cluster_electrostatics(jp.elec_params, jpos)[0])
        assert abs(e_el - je) <= 1e-10 * abs(je), (e_el, je)

    e0, el0, tb0, f0 = energies(pot)
    th = np.asarray(pot.elec_params.thole, float).copy()
    th[2] *= 2.0
    pot2 = pot.with_updated_params(thole=th)
    e2, el2, tb2, _ = energies(pot2)
    assert abs(el2 - el0) > 1e-3
    np.testing.assert_allclose(tb2, tb0, rtol=1e-12)
    assert pot2.config.thole == tuple(th) and pot.config.thole is None
    check(pot2, jpot.with_updated_params(thole=th))

    pot3 = pot.with_updated_params(include_charge_redistribution=False)
    e3, el3, _, _ = energies(pot3)
    assert not pot3.config.include_charge_redistribution
    q = np.asarray(pot3.elec_params.charges, float) * 0.5
    pot4 = pot3.with_updated_params(charges=q)
    e4, el4, _, _ = energies(pot4)
    assert abs(el4) < abs(el3)
    jpot3 = jpot.with_updated_params(include_charge_redistribution=False)
    check(pot3, jpot3)
    check(pot4, jpot3.with_updated_params(charges=q))
    pot6 = pot.with_updated_params(damping=np.asarray(pot.elec_params.damping) * 1.1,
                                   polarity=np.asarray(pot.elec_params.polarity) * 0.9,
                                   target_epsilon=1e-9, max_iterations=300)
    check(pot6, jpot.with_updated_params(damping=np.asarray(jpot.elec_params.damping) * 1.1,
                                         polarity=np.asarray(jpot.elec_params.polarity) * 0.9,
                                         target_epsilon=1e-9, max_iterations=300))
    assert (pot6.elec_params.target_epsilon, pot6.elec_params.max_iterations) == (1e-9, 300)

    with pytest.raises(ValueError, match='particle count'):
        pot.with_updated_params(charges=np.zeros(5))

    # the round trip to the original parameters reproduces e0 exactly
    pot5 = pot2.with_updated_params(thole=np.asarray(pot.elec_params.thole, float))
    e5, _, _, f5 = energies(pot5)
    assert e5 == e0 and torch.equal(f5, f0)

    # the same bits as a fresh potential built with that thole
    fresh = MBPol(pot.system, MBPolConfig(nonbonded_method='NoCutoff', thole=tuple(th)),
                  device='cpu')
    e_f, _, _, f_f = energies(fresh)
    assert e_f == e2 and torch.equal(f_f, energies(pot2)[3])


def test_with_updated_params_carries_capacities():
    """On a PME box with lists: the tuned capacities, the PME setup and the
    device carry over to the updated potential."""
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
    from mbpol_openmm_plugin_tpu_torch.system import System

    d = fixtures.load('water14')
    pot = MBPol(System.from_atom_names(d['names'], d['resnames'], box=PME_BOX),
                MBPolConfig(nonbonded_method='PME', use_neighbor_lists=True), device='cpu')
    pot.tune_capacities(_positions('water14'))
    new = pot.with_updated_params(thole=[0.4, 0.4, 0.06, 0.6, 0.05])
    assert (new.pair_cap, new.trip_cap, new.nlist_k_max, new.nlist_kt) == (
        pot.pair_cap, pot.trip_cap, pot.nlist_k_max, pot.nlist_kt)
    assert new.pme is pot.pme and new.device == pot.device
    assert new.elec_params is not pot.elec_params
    with pytest.raises(ValueError, match='no electrostatics'):
        MBPol(pot.system, MBPolConfig(nonbonded_method='PME', terms=('one_body',)),
              device='cpu').with_updated_params(thole=[0.4] * 5)
