"""The plain reference against the upstream plugin's goldens (so that an
error in the constant tables that the reference and the port share cannot
hide), and against the port's CPU path (float64) on the water256 box, the
smallest bulk box the benchmark holds (the 0.9 nm PME cutoff needs a box
over 1.8 nm): every term and the forces."""
import os

import numpy as np
import pytest
import torch

from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.system import (System, compute_virtual_sites,
                                                  make_molecules_whole)
from port_bench.harness import spec, sut
from port_bench.reference import mbpol as R

from ._cpu import water256

FIXTURES = os.path.join(spec.ROOT, 'tests', 'fixtures')


@pytest.fixture(scope='module')
def box_and_port():
    cfg = water256()
    names, resnames, positions = sut.load_positions(cfg)
    box = [cfg['box_nm']] * 3
    system = System.from_atom_names(names, resnames, box=box)
    pos = torch.as_tensor(positions, dtype=torch.float64)
    pos = compute_virtual_sites(system, make_molecules_whole(system, pos))
    # jiggle the fixture so that no coordinate sits on its 5-decimal grid
    gen = torch.Generator().manual_seed(7)
    pos = compute_virtual_sites(system, pos + 0.002 * torch.randn(pos.shape, generator=gen,
                                                                   dtype=torch.float64))
    pot = MBPol(system, MBPolConfig.for_dynamics(scf_method='sor', target_epsilon=1e-9),
                device='cpu')
    e, f, parts, _ = pot.energy_forces(pos)
    return cfg, pos.numpy(), box, {k: float(v) for k, v in parts.items()}, f.numpy()


def test_reference_matches_the_port(box_and_port):
    cfg, pos, box, parts, forces = box_and_port
    r = R.evaluate(pos, box, cfg, scf_epsilon=1e-9)
    for term in ('one_body', 'two_body', 'three_body', 'dispersion'):
        assert abs(r['terms'][term] - parts[term]) < 1e-6, term
    # the two SOR loops stop at slightly different dipoles
    assert abs(r['terms']['electrostatics'] - parts['electrostatics']) < 1e-3
    f = r['forces'].numpy()
    assert np.max(np.abs(f - forces)) < 1e-6 * np.max(np.abs(forces))
    assert np.all(f.reshape(-1, 4, 3)[:, 3] == 0.0)


def test_reference_in_float32_differs(box_and_port):
    """The control's arithmetic reaches the result (on the CPU without
    TF32: plain float32)."""
    cfg, pos, box, parts, forces = box_and_port
    r = R.evaluate(pos, box, cfg, dtype=torch.float32, scf_epsilon=1e-5)
    f = r['forces'].double().numpy()
    gap = np.max(np.abs(f - forces)) / np.max(np.abs(forces))
    assert 1e-9 < gap < 1e-1


def test_triplets_are_the_brute_force_set():
    gen = torch.Generator().manual_seed(3)
    o = torch.rand((40, 3), generator=gen, dtype=torch.float64) * 1.2
    box = torch.tensor([1.2, 1.2, 1.2], dtype=torch.float64)
    t = {tuple(x) for x in R.water_triplets(o, box, 0.45).tolist()}
    d = o[None] - o[:, None]
    d = d - torch.floor(d / box + 0.5) * box
    near = (torch.linalg.norm(d, dim=-1) < 0.45).numpy().astype(int)
    brute = {(i, j, k) for i in range(40) for j in range(i + 1, 40) for k in range(j + 1, 40)
             if near[i, j] + near[i, k] + near[j, k] >= 2}
    assert t == brute


# ---------------------------------------------------------------- goldens
# The full-precision trimer of the upstream C++ tests (Angstrom x 0.1 = nm):
# platforms/reference/tests/TestReferenceMBPol{OneBody,TwoBody,ThreeBody}Force.cpp
# use its first water, first two waters and all three.
TRIMER = np.array([
    [-1.516074336e+00, -2.023167650e-01, 1.454672917e+00],
    [-6.218989773e-01, -6.009430735e-01, 1.572437625e+00],
    [-2.017613812e+00, -4.190350349e-01, 2.239642849e+00],
    [-1.763651687e+00, -3.816594649e-01, -1.300353949e+00],
    [-1.903851736e+00, -4.935677617e-01, -3.457810126e-01],
    [-2.527904158e+00, -7.613550077e-01, -1.733803676e+00],
    [-5.588472140e-01, 2.006699172e+00, -1.392786582e-01],
    [-9.411558180e-01, 1.541226676e+00, 6.163293071e-01],
    [-9.858551734e-01, 1.567124294e+00, -8.830970941e-01],
]) * 0.1
KCAL = 4.184
# upstream's settings: PME at Ewald tolerance 1e-4, no dispersion switch
UPSTREAM = dict(cutoff=0.9, ewald_error_tolerance=1e-4, dispersion_switch_width=0.0,
                cutoff_2b=0.65, cutoff_3b=0.45)


def _sites(xyz):
    """[O, H1, H2] rows per water -> [O, H1, H2, M] rows (M placed by the
    reference)."""
    n = xyz.shape[0] // 3
    out = np.zeros((4 * n, 3))
    out.reshape(n, 4, 3)[:, :3] = xyz.reshape(n, 3, 3)
    return out


def _fixture(name):
    with np.load(os.path.join(FIXTURES, name + '.npz')) as z:
        return np.asarray(z['positions'], np.float64)


@pytest.mark.parametrize('n, term, kcal, tol', [
    (1, 'one_body', 0.55975882, 1e-6),      # TestReferenceMBPolOneBodyForce.cpp:82-113
    (2, 'two_body', 6.14207815, 1e-6),      # TestReferenceMBPolTwoBodyForce.cpp:99-127
    (3, 'three_body', 0.15586446, 1e-6),    # TestReferenceMBPolThreeBodyForce.cpp:95-141
])
def test_reference_term_goldens(n, term, kcal, tol):
    r = R.evaluate(_sites(TRIMER[:3 * n]), [3.0] * 3, UPSTREAM)
    assert abs(r['terms'][term] / KCAL - kcal) < tol, r['terms'][term] / KCAL


def test_reference_dispersion_golden():
    """python/tests/TestCustomDispersion.py:14: water3, all pairs inside a
    1.0 nm cutoff, -6.84471477 kcal/mol (the test's tolerance, 0.01)."""
    r = R.evaluate(_fixture('water3'), [3.0] * 3, dict(UPSTREAM, cutoff=1.0))
    assert abs(r['terms']['dispersion'] / KCAL - (-6.84471477)) < 0.01


def test_reference_electrostatics_golden():
    """TestReferenceMBPolElectrostaticsForce.cpp:1327
    (testWater3VirtualSitePMESmallBox): the 4-site trimer in a 1.8 nm box,
    cutoff 0.9 nm, Ewald tolerance 1e-4: -66.7426 kJ/mol (relative 1e-2)."""
    r = R.evaluate(_sites(TRIMER), [1.8] * 3, UPSTREAM)
    assert abs(r['terms']['electrostatics'] - (-66.7426)) / 66.7426 < 1e-2


@pytest.mark.parametrize('name, box, kcal, tol', [
    ('water3', 1.9, -8.92353, 0.1),        # TestReferenceMBPolIntegrationTest.py
    ('water50', 1.8, -244.37507, 1.0),
    ('water256_integration_test', 1.93996888399961804, -2270.88890, 20.0),
])
def test_reference_pme_total_goldens(name, box, kcal, tol):
    """python/tests/TestReferenceMBPolIntegrationTest.py: the whole model
    under PME, cutoff 0.9 nm."""
    r = R.evaluate(_fixture(name), [box] * 3, UPSTREAM)
    assert abs(r['energy'] / KCAL - kcal) < tol, r['energy'] / KCAL
