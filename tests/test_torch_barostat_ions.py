"""The classical Monte Carlo barostat on a periodic box with an ion, port
against the JAX package, CPU float64.

Four waters (water3's three and water_and_ion's one) and its Cl- in a 2.5 nm
box, cutoff 0.9 nm, with the terms that admit ions (one-body, two-body,
three-body, dispersion). The JAX move takes its centroids by segment_sum
over system.mol_index, the port by md/integrators.molecule_members.

(a) An accepted and a rejected monte_carlo_barostat_move, the port fed the
    JAX key splits' two uniforms: the same decision, box 1e-12, positions
    1e-12 nm, the state's energy 1e-6 kJ/mol.
(b) molecule_centroid_shift against the JAX centroids on that box (1e-12
    nm), and on a water-only layout equal bit for bit to the sum over each
    water's four sites (the layout's reshape).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import fixtures
from mbpol_openmm_plugin_tpu.md import integrators as JI
from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
from mbpol_openmm_plugin_tpu.system import System as JSystem
from mbpol_openmm_plugin_tpu.system import compute_virtual_sites
from mbpol_openmm_plugin_tpu_torch.md import integrators as I
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.system import System

torch.set_num_threads(1)

BOX = 2.5
T_K = 300.0
CFG = dict(nonbonded_method='PME', cutoff=0.9,
           terms=('one_body', 'two_body', 'three_body', 'dispersion'))
POS_ATOL = 1e-12
E_ATOL = 1e-6


def _box_with_ion():
    """(JAX System, port System, positions [21, 3] numpy with M sites)."""
    wi = fixtures.load('water_and_ion')['positions']
    w3 = fixtures.load('water3')['positions']
    jsys = JSystem.waters(4, n_ions=1, box=[BOX] * 3)
    tsys = System.waters(4, n_ions=1, box=[BOX] * 3)
    pos = compute_virtual_sites(jsys, jnp.asarray(np.concatenate([w3, wi])))
    return jsys, tsys, np.array(pos)


def test_barostat_move_with_ion_matches_jax():
    """(a) the first accepted and the first rejected move among the JAX keys
    0, 1, ...; the port is fed the same two uniforms."""
    jsys, tsys, pos = _box_with_ion()
    assert tsys.n_ions == 1 and int(tsys.mol_index.max()) + 1 == 5
    jef = jax.jit(JMBPol(jsys, JConfig(**CFG))._energy_forces_impl)
    pot = MBPol(tsys, MBPolConfig(**CFG), device='cpu')
    box0 = jnp.asarray(jsys.box)
    e0, f0, _, _ = jef(jnp.asarray(pos), None, None, box0)
    vel = np.zeros_like(pos)
    scale = 0.1 * BOX ** 3
    seen = set()
    for seed in range(40):
        key = jax.random.PRNGKey(seed)
        jstate = JI.MDState(positions=jnp.asarray(pos), velocities=jnp.asarray(vel), forces=f0,
                            potential_energy=e0, box=box0, step=jnp.zeros((), jnp.int32),
                            rng=key)
        js, j_acc = JI.monte_carlo_barostat_move(
            jsys, lambda p, box: jef(p, None, None, box)[0], jstate, T_K, 1.0, scale)
        j_acc = bool(j_acc)
        if j_acc in seen:
            continue
        seen.add(j_acc)
        _, k1, k2 = jax.random.split(key, 3)
        u = torch.as_tensor(np.array([jax.random.uniform(k1), jax.random.uniform(k2)]))
        tstate = I.MDState(positions=torch.as_tensor(pos), velocities=torch.as_tensor(vel),
                           forces=torch.as_tensor(np.array(f0)),
                           potential_energy=torch.tensor(float(e0), dtype=torch.float64),
                           box=np.array(tsys.box), step=0)
        ts, t_acc = I.monte_carlo_barostat_move(
            tsys, lambda p, box: pot._energy_forces_impl(p, box=box)[:2], tstate, T_K, 1.0,
            scale, u)
        assert t_acc == j_acc
        np.testing.assert_allclose(ts.box, np.asarray(js.box), rtol=0, atol=1e-12)
        assert np.max(np.abs(ts.positions.numpy() - np.asarray(js.positions))) <= POS_ATOL
        assert abs(float(ts.potential_energy) - float(js.potential_energy)) <= E_ATOL
        assert j_acc != np.array_equal(ts.box, tsys.box)
        if len(seen) == 2:
            break
    assert seen == {True, False}


def test_centroid_shift_with_ion_and_water_only_bits():
    """(b) the shift against JAX's segment_sum centroids with the ion; on
    water-only layouts the bits of the stride-4 sum."""
    jsys, tsys, pos = _box_with_ion()
    s = 1.0123
    mol = np.asarray(jsys.mol_index)
    m = jnp.asarray(jsys.masses)
    nmol = int(mol.max()) + 1
    centroid = (jax.ops.segment_sum(m[:, None] * jnp.asarray(pos), mol, nmol)
                / jax.ops.segment_sum(m, mol, nmol)[:, None])
    want = np.asarray(centroid * (s - 1.0))[mol]
    got = I.molecule_centroid_shift(tsys, torch.as_tensor(pos), s).numpy()
    assert np.max(np.abs(got - want)) <= POS_ATOL
    # the ion moves with its own position
    np.testing.assert_allclose(got[-1], pos[-1] * (s - 1.0), rtol=0, atol=POS_ATOL)

    rng = np.random.default_rng(3)
    for n in (1, 50):
        wsys = System.waters(n, box=[BOX] * 3)
        m4 = torch.as_tensor(np.asarray(wsys.masses)).reshape(n, 4, 1)
        for dtype in (torch.float64, torch.float32):
            p = torch.as_tensor(rng.uniform(-3.0, 3.0, (4 * n, 3)), dtype=dtype)
            p4 = p.reshape(n, 4, 3)
            m4d = m4.to(dtype)
            c = torch.sum(m4d * p4, dim=1) / torch.sum(m4d, dim=1)
            stride4 = (c * (s - 1.0))[:, None, :].expand(n, 4, 3).reshape(-1, 3)
            assert torch.equal(I.molecule_centroid_shift(wsys, p, s), stride4)
