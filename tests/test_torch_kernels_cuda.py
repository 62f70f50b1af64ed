"""The hand-written CUDA kernels of ops/elec_direct against their plain
PyTorch twins on a CUDA card, float32, at water50 and water256; and the
card's one-hot row gather (ops/gather.py).

Needs a card: each test skips without one. This file imports no jax, so
on a machine without jax it runs without the suite's conftest:

    python -m pytest --noconftest -c tests/pytest.ini -m cuda tests/test_torch_kernels_cuda.py

The entry sets and bounds are those of chip_smoke.py, from
ops/elec_direct_check.py.
"""
import os

import numpy as np
import pytest
import torch

from mbpol_openmm_plugin_tpu_torch.models import electrostatics as elec
from mbpol_openmm_plugin_tpu_torch.models.pme import PmeSetup
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPolConfig
from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_check as check
from mbpol_openmm_plugin_tpu_torch.system import (System, compute_virtual_sites,
                                                  make_molecules_whole)

pytestmark = pytest.mark.cuda

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'fixtures')
SYSTEMS = {'water50': ('water50', 1.8, 0.85),
           'water256': ('water256_integration_test', 19.3996888399961804 / 10.0, 0.9)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (the kernels have no CPU mode)')
    return torch.device('cuda')


def _sites(name, cuda):
    fname, box, cutoff = SYSTEMS[name]
    with np.load(os.path.join(FIXTURES, fname + '.npz')) as z:
        sys_ = System.from_atom_names(z['names'], z['resnames'], box=[box] * 3)
        pos = torch.as_tensor(np.array(z['positions']), dtype=torch.float32, device=cuda)
    pos = compute_virtual_sites(sys_, make_molecules_whole(sys_, pos))
    params = elec.ElecParams.for_system(sys_)
    setup = PmeSetup.from_config(sys_, MBPolConfig(nonbonded_method='PME', cutoff=cutoff))
    charges, _ = elec.assemble_charges(params, pos)
    d16 = torch.as_tensor(np.asarray(params.damping) ** (-1.0 / 6.0), dtype=torch.float32,
                          device=cuda)
    sites = ED.pack_sites(pos, charges, d16, torch.as_tensor(params.mol_index, device=cuda),
                          torch.as_tensor(params.atom_type == 0, device=cuda))
    alpha = torch.as_tensor(params.polarity, dtype=torch.float32, device=cuda)
    return sites, ED.DirectConsts.from_setup(setup, params.thole), alpha


def _assert_rows(rows):
    failed = [str(r) for r in rows if not r.ok]
    assert not failed, failed


@pytest.mark.parametrize('name', sorted(SYSTEMS))
def test_k1_matches_twin(cuda, name):
    sites, consts, alpha = _sites(name, cuda)
    before = ED.fixed_field_and_scf_factors.launches
    kern = ED.fixed_field_and_scf_factors(sites, consts)
    torch.cuda.synchronize()
    assert ED.fixed_field_and_scf_factors.launches == before + 1
    _assert_rows(check.k1_rows(sites, alpha, kern,
                               ED.fixed_field_and_scf_factors_plain(sites, consts),
                               ED.fixed_field_and_scf_factors_plain(sites.double(), consts)))


@pytest.mark.parametrize('name', sorted(SYSTEMS))
def test_k2_matches_twin(cuda, name):
    sites, consts, alpha = _sites(name, cuda)
    field, _, _ = ED.fixed_field_and_scf_factors_plain(sites, consts)
    mu = (alpha[:, None] * field).contiguous()
    before = ED.direct_energy_force_pot.launches
    kern = ED.direct_energy_force_pot(sites, mu, consts)
    torch.cuda.synchronize()
    assert ED.direct_energy_force_pot.launches == before + 1
    _assert_rows(check.k2_rows(kern, ED.direct_energy_force_pot_plain(sites, mu, consts)))


def test_float64_cuda_tensor_is_refused(cuda):
    sites, consts, _ = _sites('water50', cuda)
    with pytest.raises(TypeError):
        ED.fixed_field_and_scf_factors(sites.double(), consts)


def test_gather_rows_on_the_card_is_exact_and_deterministic(cuda):
    """The one-hot gather selects rows bit-exactly and its backward gives
    the same bits on every call."""
    from mbpol_openmm_plugin_tpu_torch.ops.gather import gather_rows
    gen = torch.Generator(device='cpu').manual_seed(0)
    table = torch.randn(256, 9, generator=gen).to(cuda).requires_grad_(True)
    idx = torch.randint(0, 256, (40000,), generator=gen).to(cuda)
    w = torch.randn(40000, 9, generator=gen).to(cuda)
    out = gather_rows(table, idx)
    assert torch.equal(out, table[idx])
    grads = [torch.autograd.grad((gather_rows(table, idx) * w).sum(), table)[0]
             for _ in range(2)]
    assert torch.equal(grads[0], grads[1])
    ref = torch.zeros_like(table).index_add_(0, idx, w)
    torch.testing.assert_close(grads[0], ref, rtol=1e-5, atol=1e-4)
