"""The plain twins of the two direct-space CUDA kernels (ops/elec_direct)
against the JAX package, CPU float64, on water50 PME (box 1.8 nm, cutoff
0.85 nm: the fixture of test_elec_pallas.py).

- against the Pallas triangular kernels in interpret mode, atol 2e-3 (the
  bound test_elec_pallas.py uses for the erfc/H2 fits of the kernels);
- in context, the port's pme_electrostatics (which reaches the twins on
  the CPU) against the JAX XLA dense path, atol 1e-8.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu.models import electrostatics as jelec
from mbpol_openmm_plugin_tpu.models import pme as jpme
from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
from mbpol_openmm_plugin_tpu.ops import elec_pallas as EP
from mbpol_openmm_plugin_tpu.system import compute_virtual_sites, make_molecules_whole
from mbpol_openmm_plugin_tpu_torch.models import pme as tpme
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
from mbpol_openmm_plugin_tpu_torch.system import System

torch.set_num_threads(1)

PALLAS_TOL = dict(rtol=0, atol=2e-3)
XLA_TOL = dict(rtol=0, atol=1e-8)


@pytest.fixture(scope='module')
def water50():
    box = [1.8] * 3
    jsys, pos = fixtures.load_system('water50', box=box)
    jpot = JMBPol(jsys, JConfig(nonbonded_method='PME', cutoff=0.85, target_epsilon=1e-7))
    pos_v = compute_virtual_sites(jsys, make_molecules_whole(jsys, pos))
    d = fixtures.load('water50')
    tsys = System.from_atom_names(d['names'], d['resnames'], box=box)
    tpot = MBPol(tsys, MBPolConfig(nonbonded_method='PME', cutoff=0.85, target_epsilon=1e-7),
                 device='cpu')
    params = jpot.elec_params
    charges, _ = jelec.assemble_charges(params, pos_v)
    d16_inv = np.asarray(params.damping) ** (-1.0 / 6.0)
    srow = EP.pack_sites(pos_v, charges, jnp.asarray(d16_inv), jnp.asarray(params.mol_index),
                         jnp.asarray(params.atom_type == 0))
    sites = ED.pack_sites(torch.as_tensor(np.array(pos_v)), torch.as_tensor(np.array(charges)),
                          torch.as_tensor(d16_inv), torch.as_tensor(params.mol_index),
                          torch.as_tensor(params.atom_type == 0))
    consts = ED.DirectConsts.from_setup(tpot.pme, tpot.elec_params.thole)
    n = pos_v.shape[0]
    mu = 0.01 * np.sin(np.arange(3 * n, dtype=np.float64)).reshape(-1, 3)
    return dict(jpot=jpot, tpot=tpot, pos_v=pos_v, srow=srow, sites=sites, consts=consts,
                n=n, mu=mu)


def test_pme_setup_matches_jax(water50):
    j, t = water50['jpot'].pme, water50['tpot'].pme
    assert (t.alpha, t.grid, t.cutoff, t.box) == (j.alpha, j.grid, j.cutoff, j.box)


def test_k1_twin_vs_pallas_interpret(water50):
    w = water50
    n = w['n']
    ef_j, s3_j, s5_j = EP.fixed_field_and_scf_factors_tri(
        w['jpot'].pme, w['jpot'].elec_params.thole, w['srow'], n, interpret=True)
    ef_t, s3_t, s5_t = ED.fixed_field_and_scf_factors(w['sites'], w['consts'])
    assert s3_t.shape == (n, n)
    np.testing.assert_allclose(ef_t.numpy(), np.asarray(ef_j), **PALLAS_TOL)
    np.testing.assert_allclose(s3_t.numpy(), np.asarray(s3_j)[:n, :n], **PALLAS_TOL)
    np.testing.assert_allclose(s5_t.numpy(), np.asarray(s5_j)[:n, :n], **PALLAS_TOL)
    np.testing.assert_allclose(s3_t.numpy(), s3_t.numpy().T, rtol=1e-12, atol=0)


def test_k2_twin_vs_pallas_interpret(water50):
    w = water50
    e_j, f_j, p_j = EP.direct_energy_force_pot_tri(
        w['jpot'].pme, w['jpot'].elec_params.thole, w['srow'], jnp.asarray(w['mu']), w['n'],
        interpret=True)
    e_t, f_t, p_t = ED.direct_energy_force_pot(w['sites'], torch.as_tensor(w['mu']), w['consts'])
    np.testing.assert_allclose(float(e_t), float(e_j), **PALLAS_TOL)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), **PALLAS_TOL)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), **PALLAS_TOL)


@pytest.mark.parametrize('mu0', [None, 'warm'])
def test_pme_electrostatics_vs_jax_xla_dense(water50, mu0):
    """The port's PME electrostatics (twins on the CPU) against the JAX XLA
    dense path: energy, forces, induced dipoles, site potential, charges,
    and equal SOR iteration counts (cold start and warm start)."""
    w = water50
    pos_v = w['pos_v']
    m0 = None if mu0 is None else 0.9 * w['mu']
    os.environ['MBPOL_ELEC_PALLAS'] = '0'
    try:
        e_j, f_j, d_j = jpme.pme_electrostatics(
            w['jpot'].elec_params, w['jpot'].pme, pos_v,
            mu0=None if m0 is None else jnp.asarray(m0))
    finally:
        os.environ.pop('MBPOL_ELEC_PALLAS', None)
    e_t, f_t, d_t = tpme.pme_electrostatics(
        w['tpot'].elec_params, w['tpot'].pme, torch.as_tensor(np.array(pos_v)),
        mu0=None if m0 is None else torch.as_tensor(m0))
    np.testing.assert_allclose(float(e_t), float(e_j), **XLA_TOL)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), **XLA_TOL)
    for k in ('induced_dipoles', 'site_potential', 'charges'):
        np.testing.assert_allclose(d_t[k].numpy(), np.asarray(d_j[k]), **XLA_TOL)
    assert int(d_t['iterations']) == int(d_j['iterations'])
    assert bool(d_t['converged']) and bool(d_j['converged'])


def test_wrappers_dispatch_cpu_to_twin_and_refuse_other_dtypes(water50):
    """A CPU tensor takes the twin and launches nothing."""
    w = water50
    ED.reset_launch_counts()
    ED.fixed_field_and_scf_factors(w['sites'].float(), w['consts'])
    ED.direct_energy_force_pot(w['sites'], torch.as_tensor(w['mu']), w['consts'])
    assert [k.launches for k in ED.KERNELS] == [0, 0]
    with pytest.raises(ValueError):
        ED.fixed_field_and_scf_factors(w['sites'][:, :7], w['consts'])
    with pytest.raises(ValueError):
        ED.direct_energy_force_pot(w['sites'], torch.zeros(3, 3, dtype=torch.float64),
                                   w['consts'])


@pytest.mark.parametrize('where', ['nearest', 'far'])
def test_kernel_check_catches_a_one_percent_s5_error(water50, where):
    """ops/elec_direct_check (the chip_smoke.py bounds): the float32 twin
    passes against itself, and a 1% error in one cross-molecule s5 entry
    between polarizable sites fails it, near or far."""
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_check as check
    w = water50
    sites, consts = w['sites'], w['consts']
    polarity = torch.as_tensor(w['tpot'].elec_params.polarity)
    t32 = ED.fixed_field_and_scf_factors(sites.float(), consts)
    t64 = ED.fixed_field_and_scf_factors(sites, consts)
    assert all(r.ok for r in check.k1_rows(sites, polarity, t32, t32, t64))

    pol = polarity > 0
    mol = sites[:, 5]
    cross = pol[:, None] & pol[None, :] & (mol[:, None] != mol[None, :]) & (t64[2] != 0)
    mags = torch.where(cross, t64[2].abs(), float('nan'))
    pick = torch.nanquantile(mags[cross], 0.5 if where == 'far' else 1.0)
    i, j = [int(x) for x in torch.nonzero(mags == pick)[0]]
    s5 = t32[2].clone()
    s5[i, j] *= 1.01
    s5[j, i] *= 1.01
    rows = check.k1_rows(sites, polarity, (t32[0], t32[1], s5), t32, t64)
    assert {(r.output, r.entries) for r in rows if not r.ok} == {('s5', 'polarizable pairs')}
