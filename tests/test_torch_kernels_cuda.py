"""The hand-written CUDA kernels of ops/elec_direct against their plain
PyTorch twins (full and triangular) on a CUDA card, float32, at water50
and water256, with s3/s5 exactly symmetric, the outputs the same bits on
a repeat and every entry written; the block-sparse kernels of
ops/elec_direct_bs against theirs at water1024 (the water256 fixture
repeated 2 x 2 x 1, 16 row tiles, sorted as
tune_capacities sorts it), also on each of 4 shards' local lists (a row-tile
range); the full-grid row kernels (#3/#4) against their row twins, shard
by shard, with the padded rows and columns of a mesh exact zeros, the same
bits on a repeat and every entry written; the
fused PIP kernels of ops/pip_fused against
theirs on seeded variables and on the water256 lists' variables; and the
card's row gather (ops/gather.py).

Needs a card: each test skips without one. This file imports no jax, so
on a machine without jax it runs without the suite's conftest:

    python -m pytest --noconftest -c tests/pytest.ini -m cuda tests/test_torch_kernels_cuda.py

The entry sets and bounds are those of chip_smoke.py, from
ops/elec_direct_check.py and ops/pip_fused_check.py.
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


def _dense_calls(name, cuda):
    """K1 and K2 as calls on the named system (K2 on polarity times K1's
    field), and the shapes of each wrapper's outputs and partials scratch
    in its allocation order."""
    sites, consts, alpha = _sites(name, cuda)
    n = sites.shape[0]
    nt = -(-n // ED.TILE)
    mu = (alpha[:, None] * ED.fixed_field_and_scf_factors(sites, consts)[0]).contiguous()
    return ((lambda: ED.fixed_field_and_scf_factors(sites, consts),
             [(n, 3), (n, n), (n, n), (nt, 3, n)]),
            (lambda: ED.direct_energy_force_pot(sites, mu, consts),
             [(n, 3), (n,), (n,), (nt, 5, n)]))


@pytest.mark.parametrize('name', sorted(SYSTEMS))
def test_k1_k2_match_triangular_twins(cuda, name):
    """The kernels against the twins of their own decomposition, on the entry
    sets and bounds of ops/elec_direct_check.py."""
    sites, consts, alpha = _sites(name, cuda)
    kern = ED.fixed_field_and_scf_factors(sites, consts)
    _assert_rows(check.k1_rows(sites, alpha, kern,
                               ED.fixed_field_and_scf_factors_tri_plain(sites, consts),
                               ED.fixed_field_and_scf_factors_tri_plain(sites.double(), consts)))
    mu = (alpha[:, None] * kern[0]).contiguous()
    _assert_rows(check.k2_rows(ED.direct_energy_force_pot(sites, mu, consts),
                               ED.direct_energy_force_pot_tri_plain(sites, mu, consts)))


@pytest.mark.parametrize('name', sorted(SYSTEMS))
def test_k1_scf_factors_exactly_symmetric(cuda, name):
    sites, consts, _ = _sites(name, cuda)
    _, s3, s5 = ED.fixed_field_and_scf_factors(sites, consts)
    for s in (s3, s5):
        assert torch.equal(s, s.T)
        assert not bool(s.diagonal().any())


@pytest.mark.parametrize('name', sorted(SYSTEMS))
def test_dense_kernels_bitwise_reproducible(cuda, name):
    for call, _ in _dense_calls(name, cuda):
        a, b = call(), call()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize('name', sorted(SYSTEMS))
def test_dense_kernels_write_every_entry(cuda, name):
    """Each wrapper right after NaN-filled tensors of its outputs' and
    scratch's sizes are freed (the caching allocator hands the memory back):
    every output is finite."""
    for call, shapes in _dense_calls(name, cuda):
        torch.cuda.synchronize()
        junk = [torch.full(s, float('nan'), device=cuda) for s in shapes]
        del junk
        out = call()
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(t).all()) for t in out)


@pytest.mark.parametrize('shards', [1, 8])
@pytest.mark.parametrize('name', sorted(SYSTEMS))
def test_row_kernels_match_twins(cuda, name, shards):
    from mbpol_openmm_plugin_tpu_torch.parallel import mesh as M
    sites, consts, alpha = _sites(name, cuda)
    n = sites.shape[0]
    mesh = M.make_mesh(devices=[cuda] * shards)
    n_pad = M.padded_for_mesh(n, shards)
    mu = (alpha[:, None] * ED.fixed_field_and_scf_factors(sites, consts)[0]).contiguous()
    for lo, hi in M.row_ranges(n_pad, mesh):
        before = [k.launches for k in ED.ROW_KERNELS]
        k1 = ED.fixed_field_and_scf_factors_rows(sites, lo, hi, consts, n_pad)
        k2 = ED.direct_energy_force_pot_rows(sites, mu, lo, hi, consts)
        torch.cuda.synchronize()
        assert [k.launches for k in ED.ROW_KERNELS] == [b + 1 for b in before]
        assert k1[1].shape == (hi - lo, n_pad)
        real = max(min(hi, n) - lo, 0)
        for out in k1 + k2:
            assert not bool(out[real:].any())         # padded rows: exact zeros
        assert not bool(k1[1][:, n:].any()) and not bool(k1[2][:, n:].any())
        if not real:
            continue
        _assert_rows(check.k1_rows_range(
            sites, alpha, lo, hi, k1,
            ED.fixed_field_and_scf_factors_rows_plain(sites, lo, hi, consts, n_pad),
            ED.fixed_field_and_scf_factors_rows_plain(sites.double(), lo, hi, consts, n_pad)))
        t2 = ED.direct_energy_force_pot_rows_plain(sites, mu, lo, hi, consts)
        _assert_rows(check.k2_rows((k2[0][:real].sum(), k2[1][:real], k2[2][:real]),
                                   (t2[0][:real].sum(), t2[1][:real], t2[2][:real])))


@pytest.mark.parametrize('shards', [1, 4, 8])
@pytest.mark.parametrize('name', sorted(SYSTEMS))
def test_row_kernels_bitwise_reproducible_and_write_every_entry(cuda, name, shards):
    """Each shard's #3/#4 launched twice on the same inputs gives the same
    bits, and right after NaN-filled tensors of their outputs' sizes are
    freed (the caching allocator hands the memory back) every output is
    finite: the wrappers allocate no zero fill and no scratch, so the
    kernels write every entry."""
    from mbpol_openmm_plugin_tpu_torch.parallel import mesh as M
    sites, consts, alpha = _sites(name, cuda)
    n = sites.shape[0]
    n_pad = M.padded_for_mesh(n, shards)
    mu = (alpha[:, None] * ED.fixed_field_and_scf_factors(sites, consts)[0]).contiguous()
    for lo, hi in M.row_ranges(n_pad, M.make_mesh(devices=[cuda] * shards)):
        rows = hi - lo
        calls = ((lambda: ED.fixed_field_and_scf_factors_rows(sites, lo, hi, consts, n_pad),
                  [(rows, 3), (rows, n_pad), (rows, n_pad)]),
                 (lambda: ED.direct_energy_force_pot_rows(sites, mu, lo, hi, consts),
                  [(rows, 3), (rows,), (rows,)]))
        for call, shapes in calls:
            torch.cuda.synchronize()
            junk = [torch.full(s, float('nan'), device=cuda) for s in shapes]
            del junk
            a = call()
            b = call()
            torch.cuda.synchronize()
            assert all(bool(torch.isfinite(t).all()) for t in a)
            assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_float64_cuda_tensor_is_refused(cuda):
    sites, consts, _ = _sites('water50', cuda)
    with pytest.raises(TypeError):
        ED.fixed_field_and_scf_factors(sites.double(), consts)


@pytest.fixture(scope='module')
def water1024_block():
    """Sorted packed sites, polarity, tile list and constants of water1024
    in block mode, on the card (None without one)."""
    if not torch.cuda.is_available():
        return None
    from mbpol_openmm_plugin_tpu_torch.models import pme
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol
    from mbpol_openmm_plugin_tpu_torch.system import replicate
    fname, box, cutoff = SYSTEMS['water256']
    with np.load(os.path.join(FIXTURES, fname + '.npz')) as z:
        sys_ = System.from_atom_names(z['names'], z['resnames'], box=[box] * 3)
        pos = torch.as_tensor(np.array(z['positions']), dtype=torch.float32, device='cuda')
    big, pos = replicate(sys_, make_molecules_whole(sys_, pos), (2, 2, 1))
    pos = compute_virtual_sites(big, pos)
    pot = MBPol(big, MBPolConfig(nonbonded_method='PME', cutoff=cutoff,
                                 electrostatics_mode='block')).tune_capacities(pos)
    params, block = pot.elec_params, pot._block_info
    charges, _ = elec.assemble_charges(params, pos)
    sites, (tiles,) = pme.block_sites(params, pot.pme, pos, charges, block)
    polarity = torch.as_tensor(params.polarity[block['site_perm']], dtype=torch.float32,
                               device='cuda')
    return sites, polarity, tiles, pos.shape[0], ED.DirectConsts.from_setup(pot.pme,
                                                                             params.thole)


def test_block_kernels_match_twins(cuda, water1024_block):
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as bs
    sites, polarity, tiles, n, consts = water1024_block
    assert int(tiles.n_act) <= tiles.capacity
    before = [k.launches for k in bs.KERNELS]
    checks = check.block_kernel_rows(sites, polarity, tiles, n, consts)
    torch.cuda.synchronize()
    assert [k.launches for k in bs.KERNELS] == [b + 1 for b in before]
    for name, (rows, _) in checks.items():
        _assert_rows(rows)


def test_sharded_block_kernels_match_twins(cuda, water1024_block):
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as bs
    from mbpol_openmm_plugin_tpu_torch.parallel import mesh as M
    sites, polarity, tiles, n, consts = water1024_block
    mesh = M.make_mesh(devices=[cuda] * 4)
    cap = tiles.capacity // 2
    shard_tiles = bs.active_tile_pairs_sharded(sites[:, :3], n, consts.box, consts.cutoff, cap,
                                               mesh)
    assert sum(int(t.n_act) for t in shard_tiles) == int(tiles.n_act)
    field = bs.fixed_field_and_scf_lines(sites, n, tiles, consts)[0]
    mu = (polarity[:, None] * field).contiguous()
    for t in shard_tiles:
        assert 0 < int(t.n_act) <= t.capacity
        checks = check.block_kernel_rows(sites, polarity, t, n, consts, mu=mu)
        torch.cuda.synchronize()
        for name, (rows, _) in checks.items():
            _assert_rows(rows)


def _moved(sites, box, how):
    """Sorted sites with the positions shifted by box vectors (unwrapped
    coordinates far from the box) or shifted and wrapped per site into the
    box (waters and column clusters across the periodic boundary)."""
    b = torch.as_tensor(box, dtype=sites.dtype, device=sites.device)
    xyz = sites[:, :3]
    if how == 'shifted':
        xyz = xyz + b * torch.tensor([3.0, -2.0, 5.0], dtype=sites.dtype, device=sites.device)
    else:
        xyz = xyz + b * torch.tensor([0.5, 0.37, 0.61], dtype=sites.dtype, device=sites.device)
        xyz = xyz - torch.floor(xyz / b) * b
    return torch.cat([xyz, sites[:, 3:]], dim=1).contiguous()


@pytest.mark.parametrize('how', ['shifted', 'wrapped', 'ragged'])
def test_culled_block_kernels_match_twins(cuda, water1024_block, how):
    """K1-bs, K3-bs and K2-bs cull (water, cluster) lines by boxes: on
    unwrapped positions, on waters and clusters across the boundary, and
    with a ragged last tile (the last 10 waters taken as padding, their
    sites left in place), against the twins on the entry sets of
    ops/elec_direct_check.py."""
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as bs
    sites, polarity, tiles, n, consts = water1024_block
    if how == 'ragged':
        n = n - 40
        polarity = polarity[:n]
        tiles = bs.active_tile_pairs(sites[:, :3], n, consts.box, consts.cutoff,
                                     tiles.capacity)
    else:
        sites = _moved(sites, consts.box, how)
    assert int(tiles.n_act) <= tiles.capacity
    live = bs.live_lines(sites[:, :3], n, tiles, consts.box, consts.cutoff)
    assert 0 < int(live.sum()) < live.numel()
    checks = check.block_kernel_rows(sites, polarity, tiles, n, consts)
    torch.cuda.synchronize()
    for rows, _ in checks.values():
        _assert_rows(rows)


def _stored(lines):
    """(count, entry, s3, s5) of the lines K1-bs stored: the slots past a
    slab's count are unwritten."""
    stored = (torch.arange(lines.capacity, device=lines.count.device)
              < lines.count[..., None])
    return lines.count, lines.entry[stored], lines.s3[stored], lines.s5[stored]


def test_culled_block_kernels_are_bitwise_reproducible(cuda, water1024_block):
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as bs
    sites, polarity, tiles, n, consts = water1024_block
    k1 = [bs.fixed_field_and_scf_lines(sites, n, tiles, consts) for _ in range(2)]
    field, lines = k1[0]
    mu = (polarity[:, None] * field).contiguous()
    mu_pad = bs.pad_rows(mu, sites.shape[0])
    k3 = [bs.scf_dipole_field_bs(sites, lines, mu_pad, tiles, n, consts) for _ in range(2)]
    k2 = [bs.direct_energy_force_pot_bs(sites, mu, n, tiles, consts) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(k1[0][0], k1[1][0])
    assert all(torch.equal(a, b) for a, b in zip(_stored(k1[0][1]), _stored(k1[1][1])))
    assert torch.equal(k3[0], k3[1])
    assert all(torch.equal(a, b) for a, b in zip(*k2))


def test_k1_bs_lines_hold_the_block_twins_live_lines(cuda, water1024_block):
    """K1-bs's lines spread into blocks against the block twin (the Pallas
    kernel's layout) on the entry sets of ops/elec_direct_check.py, and
    every pair with a nonzero s3 or s5 in the twin's blocks lies in one of
    the kernel's lines (its culling is conservative)."""
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as bs
    sites, polarity, tiles, n, consts = water1024_block
    field, lines = bs.fixed_field_and_scf_lines(sites, n, tiles, consts)
    assert not bool(lines.overflow())
    kern = (field,) + bs.lines_to_blocks(lines, tiles)
    twin = bs.fixed_field_and_scf_blocks_plain(sites, n, tiles, consts)
    _assert_rows(check.k1_bs_rows(sites, polarity, tiles, n, kern, twin,
                                  bs.fixed_field_and_scf_blocks_plain(sites.double(), n, tiles,
                                                                      consts)))
    ones = bs.ScfLines(torch.ones_like(lines.s3), torch.ones_like(lines.s5), lines.entry,
                       lines.count)
    in_line = bs.lines_to_blocks(ones, tiles)[0] > 0
    assert not bool((((twin[1] != 0) | (twin[2] != 0)) & ~in_line).any())


def test_block_kernels_refuse_float64(cuda, water1024_block):
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as bs
    sites, _, tiles, n, consts = water1024_block
    with pytest.raises(TypeError):
        bs.fixed_field_and_scf_lines(sites.double(), n, tiles, consts)


@pytest.mark.parametrize('masked', [False, True])
def test_gather_rows_on_the_card_is_exact_and_deterministic(cuda, masked):
    """The gather selects rows bit-exactly and its backward gives the same
    bits on every call (with a list mask: padded entries, all index 0,
    left out of the backward)."""
    from mbpol_openmm_plugin_tpu_torch.ops.gather import gather_rows
    gen = torch.Generator(device='cpu').manual_seed(0)
    table = torch.randn(256, 9, generator=gen).to(cuda).requires_grad_(True)
    idx = torch.randint(0, 256, (40000,), generator=gen).to(cuda)
    w = torch.randn(40000, 9, generator=gen).to(cuda)
    mask = None
    if masked:
        mask = torch.arange(40000, device=cuda) < 30000
        idx = torch.where(mask, idx, 0)
    out = gather_rows(table, idx, mask)
    assert torch.equal(out, table[idx])
    grads = [torch.autograd.grad((gather_rows(table, idx, mask) * w).sum(), table)[0]
             for _ in range(2)]
    assert torch.equal(grads[0], grads[1])
    keep = slice(None) if mask is None else mask
    ref = torch.zeros_like(table).index_add_(0, idx[keep], w[keep])
    torch.testing.assert_close(grads[0], ref, rtol=1e-5, atol=1e-4)


def _pip_variables(name, source, cuda):
    """[P, V] float32 on the card: 'seeded' rows uniform in [1e-4, 1] (a
    count that is no multiple of the kernels' 64-row tiles), or the
    variables the water256 lists give the two-/three-body term."""
    from mbpol_openmm_plugin_tpu_torch.ops import polyeval
    if source == 'seeded':
        nv = polyeval.load_pip(name).nvars
        x = np.random.default_rng(nv).uniform(1e-4, 1.0, (4096 + 17, nv)).astype(np.float32)
        return torch.as_tensor(x, device=cuda)
    from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol
    from mbpol_openmm_plugin_tpu_torch.models.three_body import three_body_variables
    from mbpol_openmm_plugin_tpu_torch.models.two_body import two_body_variables
    fname, box, _ = SYSTEMS['water256']
    with np.load(os.path.join(FIXTURES, fname + '.npz')) as z:
        sys_ = System.from_atom_names(z['names'], z['resnames'], box=[box] * 3)
        pos = torch.as_tensor(np.array(z['positions']), dtype=torch.float32, device=cuda)
    pos = compute_virtual_sites(sys_, make_molecules_whole(sys_, pos))
    (pl, tl), _ = MBPol(sys_, MBPolConfig.for_dynamics()).build_neighbor_lists(pos)
    if name == 'poly2b':
        return two_body_variables(sys_, pos, pl[0], pl[1]).contiguous()
    return three_body_variables(sys_, pos, tl[0], tl[1]).contiguous()


PIP_IMPLS = ('pallas', 'quad_pallas', 'quad_bf16', 'vech_pallas')


@pytest.mark.parametrize('source', ['seeded', 'water256'])
@pytest.mark.parametrize('name', ['poly2b', 'poly3b'])
@pytest.mark.parametrize('impl', PIP_IMPLS)
def test_pip_kernel_matches_twin(cuda, impl, name, source):
    from mbpol_openmm_plugin_tpu_torch.ops import pip_fused, pip_fused_check
    wrapper = pip_fused.WRAPPERS[impl]
    x = _pip_variables(name, source, cuda)
    before = wrapper.launches
    rows, _ = pip_fused_check.kernel_rows(wrapper, name, x, physical=source == 'water256')
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _assert_rows(rows)


@pytest.mark.parametrize('impl', PIP_IMPLS)
def test_pip_kernel_is_bitwise_reproducible_and_refuses_float64(cuda, impl):
    from mbpol_openmm_plugin_tpu_torch.ops import pip_fused
    wrapper = pip_fused.WRAPPERS[impl]
    x = _pip_variables('poly3b', 'seeded', cuda)
    e0, g0 = wrapper('poly3b', x)
    e1, g1 = wrapper('poly3b', x)
    assert torch.equal(e0, e1) and torch.equal(g0, g1)
    # a tail tile's rows do not depend on the batch around them
    e2, g2 = wrapper('poly3b', x[:45].contiguous())
    assert torch.equal(e2, e0[:45]) and torch.equal(g2, g0[:45])
    with pytest.raises(TypeError):
        wrapper('poly3b', x.double())


@pytest.mark.parametrize('rows', [1, 63, 64, 65, 129, 33801])
@pytest.mark.parametrize('impl', PIP_IMPLS)
def test_tensor_core_pip_kernels_on_ragged_batches(cuda, impl, rows):
    """The four PIP kernels own 64 rows per block: batches around one
    and two blocks, and one above two waves of blocks of the quadratic
    forms (2 x 2 x 132 x 64 rows on an H100), have in every row the bits
    that row has in a larger
    batch (a row does not depend on the rows around it or on where its
    block runs), and the larger batch matches the twin (its 4096 further
    rows set the scale of the bound: one row's energy can cancel to
    nothing)."""
    from mbpol_openmm_plugin_tpu_torch.ops import pip_fused, pip_fused_check, polyeval
    wrapper = pip_fused.WRAPPERS[impl]
    nv = polyeval.load_pip('poly3b').nvars
    x = torch.as_tensor(np.random.default_rng(rows).uniform(
        1e-4, 1.0, (rows + 4096, nv)).astype(np.float32), device=cuda)
    blocks, waves = pip_fused.launch_shape(
        rows, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert blocks == -(-rows // 64) and (rows < 33801 or waves > 2.0)
    assert pip_fused.launch_shape(rows, 132, pip_fused.MONO_BLOCKS_PER_SM)[0] == blocks
    check, _ = pip_fused_check.kernel_rows(wrapper, 'poly3b', x)
    _assert_rows(check)
    e_all, g_all = wrapper('poly3b', x)
    e, g = wrapper('poly3b', x[:rows].contiguous())
    torch.cuda.synchronize()
    assert e.shape == (rows,) and g.shape == (rows, nv)
    assert bool(torch.isfinite(e).all()) and bool(torch.isfinite(g).all())
    assert torch.equal(e, e_all[:rows]) and torch.equal(g, g_all[:rows])
