"""The port's PME in a 50 nm box reproduces the cluster result, CPU float64:
the counterpart of tests/test_pme.py::test_pme_huge_box_equals_cluster
(platforms/reference/tests/TestReferenceMBPolElectrostaticsForce.cpp
testWater3PMEHugeBox, :895).

Three-site water3, alpha 1e-15, grid 20^3, cutoff 0.9 nm, box 50 nm,
target_epsilon 1e-12: the energy within 1e-3 kcal/mol of the golden
-7.08652 and the golden forces (rtol/atol 1e-3 in kcal/mol/A), as the JAX
test holds them; and the port against the JAX package's
P.pme_electrostatics on the same input, 1e-9 relative.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from mbpol_openmm_plugin_tpu.models import electrostatics as JE
from mbpol_openmm_plugin_tpu.models import pme as JP
from mbpol_openmm_plugin_tpu_torch.models import electrostatics as E
from mbpol_openmm_plugin_tpu_torch.models import pme as P
from mbpol_openmm_plugin_tpu_torch.utils import units
from test_electrostatics_cluster import GOLDEN_W3_FORCES_KCAL_A, WATER3_POS9
from test_torch_cluster import three_site_params

SETUP = dict(alpha=1e-15, grid=(20, 20, 20), cutoff=0.9, box=(50.0, 50.0, 50.0))
GOLDEN_KCAL = -7.08652
JAX_REL = 1e-9


def test_pme_huge_box_equals_cluster_and_jax():
    tp = dataclasses.replace(three_site_params(E), target_epsilon=1e-12)
    energy, forces, diag = P.pme_electrostatics(tp, P.PmeSetup(**SETUP),
                                                torch.as_tensor(WATER3_POS9))
    assert bool(diag['converged'])
    e_kcal = float(energy) * units.KJ_PER_MOL_TO_KCAL_PER_MOL
    assert abs(e_kcal - GOLDEN_KCAL) < 1e-3, e_kcal
    f_kcal_a = forces.numpy() * units.KJ_PER_MOL_TO_KCAL_PER_MOL / units.NM_TO_ANGSTROM
    np.testing.assert_allclose(f_kcal_a, GOLDEN_W3_FORCES_KCAL_A, rtol=1e-3, atol=1e-3)

    jp = dataclasses.replace(three_site_params(JE), target_epsilon=1e-12)
    e_j, f_j, diag_j = JP.pme_electrostatics(jp, JP.PmeSetup(**SETUP), jnp.asarray(WATER3_POS9))
    assert bool(diag_j['converged'])
    assert abs(float(energy) - float(e_j)) <= JAX_REL * abs(float(e_j))
    f_j = np.asarray(f_j)
    assert np.max(np.abs(forces.numpy() - f_j)) <= JAX_REL * np.max(np.abs(f_j))
