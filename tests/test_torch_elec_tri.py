"""The triangular twins of the dense direct-space CUDA kernels
(ops/elec_direct.fixed_field_and_scf_factors_tri_plain,
direct_energy_force_pot_tri_plain), which mirror the kernels'
decomposition, on the CPU in float64: water50 PME (200 sites, box 1.8 nm,
cutoff 0.85 nm; the 32-site tiles do not divide it, so the last tile is
ragged) and water256 (1,024 sites, box 1.93997 nm, cutoff 0.9 nm).

- against the JAX Pallas triangular kernels in interpret mode, at
  PALLAS_TOL (atol 2e-3: test_torch_elec_direct.py's bound for the
  erfc/H2 fits of the Pallas kernels);
- against the full twins, within 1e-10 of each output's max;
- s3/s5 exactly symmetric with a zero diagonal;
- the tile-pair enumeration covers every unordered tile pair once, in runs
  of nt + 1 blocks with the same work.
"""
import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu.models import electrostatics as jelec
from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
from mbpol_openmm_plugin_tpu.ops import elec_pallas as EP
from mbpol_openmm_plugin_tpu.system import compute_virtual_sites, make_molecules_whole
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.ops import _build
from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
from mbpol_openmm_plugin_tpu_torch.system import System

torch.set_num_threads(1)

PALLAS_TOL = dict(rtol=0, atol=2e-3)
FULL_REL = 1e-10
SYSTEMS = {'water50': ('water50', 1.8, 0.85),
           'water256': ('water256_integration_test', 19.3996888399961804 / 10.0, 0.9)}


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """JAX and port inputs of one system: the JAX potential, its packed
    sites, the port's packed sites and constants (float64) and a seeded
    dipole field mu [N, 3]."""
    fname, box, cutoff = SYSTEMS[name]
    jsys, pos = fixtures.load_system(fname, box=[box] * 3)
    jpot = JMBPol(jsys, JConfig(nonbonded_method='PME', cutoff=cutoff, target_epsilon=1e-7))
    pos_v = compute_virtual_sites(jsys, make_molecules_whole(jsys, pos))
    d = fixtures.load(fname)
    tsys = System.from_atom_names(d['names'], d['resnames'], box=[box] * 3)
    tpot = MBPol(tsys, MBPolConfig(nonbonded_method='PME', cutoff=cutoff, target_epsilon=1e-7),
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
    return jpot, srow, sites, consts, mu


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize('name', sorted(SYSTEMS))
def test_k1_tri_twin_vs_pallas_interpret(name):
    jpot, srow, sites, consts, _ = _inputs(name)
    n = sites.shape[0]
    ef_j, s3_j, s5_j = EP.fixed_field_and_scf_factors_tri(jpot.pme, jpot.elec_params.thole, srow,
                                                          n, interpret=True)
    ef_t, s3_t, s5_t = ED.fixed_field_and_scf_factors_tri_plain(sites, consts)
    assert s3_t.shape == (n, n) and ef_t.shape == (n, 3)
    np.testing.assert_allclose(ef_t.numpy(), np.asarray(ef_j), **PALLAS_TOL)
    np.testing.assert_allclose(s3_t.numpy(), np.asarray(s3_j)[:n, :n], **PALLAS_TOL)
    np.testing.assert_allclose(s5_t.numpy(), np.asarray(s5_j)[:n, :n], **PALLAS_TOL)


@pytest.mark.parametrize('name', sorted(SYSTEMS))
def test_k2_tri_twin_vs_pallas_interpret(name):
    jpot, srow, sites, consts, mu = _inputs(name)
    e_j, f_j, p_j = EP.direct_energy_force_pot_tri(jpot.pme, jpot.elec_params.thole, srow,
                                                   jnp.asarray(mu), sites.shape[0],
                                                   interpret=True)
    e_t, f_t, p_t = ED.direct_energy_force_pot_tri_plain(sites, torch.as_tensor(mu), consts)
    np.testing.assert_allclose(float(e_t), float(e_j), **PALLAS_TOL)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), **PALLAS_TOL)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), **PALLAS_TOL)


@pytest.mark.parametrize('name', sorted(SYSTEMS))
def test_tri_twins_match_full_twins(name):
    """Each output of the triangular twins within FULL_REL of its max from
    the full twins (float64: only the summation order differs)."""
    _, _, sites, consts, mu = _inputs(name)
    mu = torch.as_tensor(mu)
    k1_tri = ED.fixed_field_and_scf_factors_tri_plain(sites, consts)
    k1 = ED.fixed_field_and_scf_factors_plain(sites, consts)
    k2_tri = ED.direct_energy_force_pot_tri_plain(sites, mu, consts)
    k2 = ED.direct_energy_force_pot_plain(sites, mu, consts)
    for what, a, b in zip(('field', 's3', 's5', 'e_direct', 'force', 'pot'), k1_tri + k2_tri,
                          k1 + k2):
        assert a.shape == b.shape, what
        assert _rel(a, b) <= FULL_REL, (what, _rel(a, b))


@pytest.mark.parametrize('name', sorted(SYSTEMS))
def test_tri_twin_scf_factors_exactly_symmetric(name):
    _, _, sites, consts, _ = _inputs(name)
    for dtype in (torch.float32, torch.float64):
        _, s3, s5 = ED.fixed_field_and_scf_factors_tri_plain(sites.to(dtype), consts)
        for s in (s3, s5):
            assert torch.equal(s, s.T)
            assert not bool(s.diagonal().any())
            assert bool(s.any())


@pytest.mark.parametrize('nt', [1, 2, 5, 7, 16, 32])
def test_tile_pairs_cover_each_unordered_pair_once_in_equal_runs(nt):
    """Every (ti, tj) with ti <= tj exactly once; every full run of nt + 1
    consecutive blocks holds nt - 1 off-diagonal tile pairs and 2 diagonal
    ones (the same work), and for odd nt the last, shorter run is the middle
    row tile's."""
    ti, tj = ED.tile_pairs(nt)
    pairs = list(zip(ti.tolist(), tj.tolist()))
    assert sorted(pairs) == [(a, b) for a in range(nt) for b in range(a, nt)]
    diag = (ti == tj).long()
    runs = diag.split(nt + 1)
    for run in runs[:nt // 2]:
        assert run.numel() == nt + 1 and int(run.sum()) == 2
    if nt % 2:
        mid = runs[-1]
        assert mid.numel() == (nt + 1) // 2 and int(mid.sum()) == 1
        assert set(ti[-mid.numel():].tolist()) == {nt // 2}


@pytest.mark.parametrize('name', sorted(SYSTEMS))
def test_tri_twins_write_every_scratch_slot(name, monkeypatch):
    """The row and column partials fill every (tile, site) slot of the
    [n_tiles, K, N] scratch exactly once: a scratch that starts as NaN
    instead of zeros gives the same outputs."""
    _, _, sites, consts, mu = _inputs(name)
    mu = torch.as_tensor(mu)
    ref = (ED.fixed_field_and_scf_factors_tri_plain(sites, consts)
           + ED.direct_energy_force_pot_tri_plain(sites, mu, consts))
    real_zeros = torch.Tensor.new_zeros

    def nan_scratch(t, *size, **kw):
        out = real_zeros(t, *size, **kw)
        return out.fill_(float('nan')) if len(size) == 3 else out

    monkeypatch.setattr(torch.Tensor, 'new_zeros', nan_scratch)
    got = (ED.fixed_field_and_scf_factors_tri_plain(sites, consts)
           + ED.direct_energy_force_pot_tri_plain(sites, mu, consts))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_twins_use_the_kernels_tile_and_sum_order():
    """The twins' TILE and SUM_GROUPS are the constants of
    csrc/elec_direct.cu (kTile, kSumGroups), whose entry points also refuse
    another tile."""
    with open(os.path.join(_build.CSRC_DIR, 'elec_direct.cu')) as f:
        src = f.read()
    consts = dict(re.findall(r'constexpr int (kTile|kSumGroups) = (\d+);', src))
    assert consts == {'kTile': str(ED.TILE), 'kSumGroups': str(ED.SUM_GROUPS)}
