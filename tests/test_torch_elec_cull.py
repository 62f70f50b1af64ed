"""The culling test of the block kernels K1-bs, K3-bs and K2-bs
(ops/elec_direct_bs.group_boxes / live_lines, the plain twin of the test in
csrc/elec_direct_bs.cu) and the s3/s5 layout of live lines it gives
K1-bs and K3-bs, CPU float64.

(a) Every group box holds an image of each of its real sites.
(b) The test is conservative: on water256 and water1024 (the water256
    fixture repeated 2 x 2 x 1), sorted as tune_capacities sorts them,
    every pair with a nonzero s3 or s5 from the K1-bs block twin lies in a
    live (row water, column cluster) line, with the positions as sorted,
    shifted by a box vector (unwrapped coordinates), and wrapped into the
    box after a shift (molecules and clusters across the periodic
    boundary).
(c) A K3-bs block twin that sees only the live lines (the dead ones
    zeroed, as the kernels skip them) equals the full twin bit for bit.
(d) The live share of the lines at water4096 (2 x 2 x 4) and the live
    lines per (row water, cluster) slab, logged.
(e) On the inputs of (b): the K1-bs line twin, spread into blocks
    (lines_to_blocks), is the block twin bit for bit, field included, and
    blocks_to_lines gives its lines back; the K3-bs line twin on those
    lines is the block twin on those blocks bit for bit.
(f) tune_capacities gives a line capacity that holds the most live lines
    of any slab, and no more than the column tiles.
"""
import os

import numpy as np
import pytest
import torch

from mbpol_openmm_plugin_tpu_torch.models import electrostatics as elec
from mbpol_openmm_plugin_tpu_torch.models.pme import PmeSetup
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as BS
from mbpol_openmm_plugin_tpu_torch.system import (System, compute_virtual_sites,
                                                  make_molecules_whole, replicate)

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'fixtures',
                       'water256_integration_test.npz')
BOX256 = 19.3996888399961804 / 10.0
CUTOFF = 0.9
SYSTEMS = {'water256': (1, 1, 1), 'water1024': (2, 2, 1)}
# positions as sorted; shifted by a box vector; shifted and wrapped per site
VARIANTS = ('sorted', 'shifted', 'wrapped')


def _system(reps):
    with np.load(FIXTURE) as z:
        sys1 = System.from_atom_names(z['names'], z['resnames'], box=[BOX256] * 3)
        pos = torch.as_tensor(np.array(z['positions']), dtype=torch.float64)
    pos = compute_virtual_sites(sys1, make_molecules_whole(sys1, pos))
    big, pos = replicate(sys1, pos, reps)
    return big, compute_virtual_sites(big, pos)


def _block_inputs(reps, variant):
    """(sorted packed sites [padded(n), 8], n, tile list, consts, box) in
    the order tune_capacities sorts the sites, positions per `variant`."""
    system, pos = _system(reps)
    box = np.asarray(system.box, np.float64)
    b = torch.as_tensor(box)
    if variant == 'shifted':
        pos = pos + b * torch.tensor([1.0, -2.0, 3.0], dtype=pos.dtype)
    elif variant == 'wrapped':
        pos = pos + b * torch.tensor([0.5, 0.37, 0.61], dtype=pos.dtype)
        pos = pos - torch.floor(pos / b) * b
    n = pos.shape[0]
    params = elec.ElecParams.for_system(system)
    setup = PmeSetup.from_config(system, MBPolConfig(nonbonded_method='PME', cutoff=CUTOFF))
    charges, _ = elec.assemble_charges(params, pos)
    mol_perm = BS.molecule_sort_permutation(pos[0::4].numpy(), box)
    perm = torch.as_tensor((4 * mol_perm[:, None] + np.arange(4)[None, :]).reshape(-1))
    d16 = torch.as_tensor(np.asarray(params.damping) ** (-1.0 / 6.0))
    sites = BS.pack_sites(pos[perm], charges[perm], d16[perm],
                          torch.as_tensor(params.mol_index)[perm],
                          torch.as_tensor(params.atom_type == 0)[perm])
    cap = BS.tile_pair_capacity(n, box, CUTOFF)
    tiles = BS.active_tile_pairs(sites[:, :3], n, box, CUTOFF, cap)
    assert 0 < int(tiles.n_act) <= cap
    return sites, n, tiles, ED.DirectConsts.from_setup(setup, params.thole), box


def _line_pairs(live):
    """live [cap, 64, 8] spread to the pairs of the blocks: [cap, 256, 256]."""
    return live.repeat_interleave(BS.WATER, dim=1).repeat_interleave(BS.CLUSTER, dim=2)


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('size', [BS.WATER, BS.CLUSTER])
def test_group_boxes_hold_an_image_of_every_site(size, variant):
    sites, n, _, _, box = _block_inputs(SYSTEMS['water1024'], variant)
    xyz = sites[:, :3]
    center, half = BS.group_boxes(xyz, n, box, size)
    b = torch.as_tensor(box)
    d = xyz.reshape(-1, size, 3) - center[:, None, :]
    d = d - torch.floor(d / b + 0.5) * b
    real = (torch.arange(xyz.shape[0]) < n).reshape(-1, size)
    inside = (d.abs() <= half[:, None, :]).all(dim=-1)
    assert bool(inside[real].all())
    assert bool((half[~real.any(dim=1)] == BS.EMPTY).all())     # padded groups are empty
    if size == BS.WATER:                                         # a whole water, compact
        assert float(half[real.any(dim=1)].max()) < 0.2


@pytest.fixture(scope='module')
def k1_twins():
    """{(system, variant): (inputs, K1-bs twin outputs)}, filled on use."""
    return {}


def _k1(k1_twins, name, variant):
    key = (name, variant)
    if key not in k1_twins:
        sites, n, tiles, consts, box = _block_inputs(SYSTEMS[name], variant)
        k1_twins[key] = ((sites, n, tiles, consts, box),
                         BS.fixed_field_and_scf_blocks_plain(sites, n, tiles, consts))
    return k1_twins[key]


def _k1_lines(k1_twins, name, variant):
    """The K1-bs line twin on the inputs of _k1, filled on use."""
    key = ('lines', name, variant)
    if key not in k1_twins:
        sites, n, tiles, consts, _ = _k1(k1_twins, name, variant)[0]
        k1_twins[key] = BS.fixed_field_and_scf_lines_plain(sites, n, tiles, consts)
    return k1_twins[key]


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('name', sorted(SYSTEMS))
def test_culling_is_conservative(k1_twins, name, variant):
    (sites, n, tiles, consts, box), (_, s3, s5) = _k1(k1_twins, name, variant)
    live = BS.live_lines(sites[:, :3], n, tiles, box, consts.cutoff)
    valid = ((tiles.meta & BS.VALID) > 0)[:, None, None]
    in_cutoff = ((s3 != 0) | (s5 != 0)) & valid
    assert int(in_cutoff.sum()) > 0
    assert not bool((in_cutoff & ~_line_pairs(live)).any())
    share = float(live.sum()) / float(valid.sum() * live.shape[1] * live.shape[2])
    print(f'{name} {variant}: {int(tiles.n_act)} active tile pairs, live lines {share:.4f}, '
          f'in-cutoff pairs {float(in_cutoff.sum()) / float(valid.sum() * BS.TILE ** 2):.4f}')
    if name == 'water1024':
        assert share < 0.5                                     # the test culls


@pytest.mark.parametrize('name', sorted(SYSTEMS))
def test_k3_twin_on_live_lines_is_bitwise_the_full_twin(k1_twins, name):
    (sites, n, tiles, consts, box), (_, s3, s5) = _k1(k1_twins, name, 'wrapped')
    mu = torch.as_tensor(np.random.default_rng(7).normal(0.0, 0.01, (n, 3)))
    mu_pad = BS.pad_rows(mu, sites.shape[0])
    full = BS.scf_dipole_field_blocks_plain(sites, s3, s5, mu_pad, tiles, n, consts)
    keep = _line_pairs(BS.live_lines(sites[:, :3], n, tiles, box, consts.cutoff))
    culled = BS.scf_dipole_field_blocks_plain(sites, torch.where(keep, s3, 0.0),
                                              torch.where(keep, s5, 0.0), mu_pad, tiles, n,
                                              consts)
    if name == 'water1024':                       # at water256 every line is live
        assert not bool(keep.all())
    assert torch.equal(culled, full)


def test_live_share_at_water4096():
    sites, n, tiles, consts, box = _block_inputs((2, 2, 4), 'sorted')
    live = BS.live_lines(sites[:, :3].float(), n, tiles, box, consts.cutoff)
    n_valid = int(((tiles.meta & BS.VALID) > 0).sum())
    share = float(live.sum()) / (n_valid * live.shape[1] * live.shape[2])
    n_tiles = sites.shape[0] // BS.TILE
    print(f'water4096: {int(tiles.n_act)} active tile pairs of {n_tiles ** 2}, '
          f'live (water, cluster) lines {share:.4f} of theirs')
    assert int(tiles.n_act) == n_valid
    assert 0.05 < share < 0.35
    _, count = BS.line_slots(live, tiles)
    run = torch.bincount(tiles.ti[(tiles.meta & BS.VALID) > 0].long(), minlength=n_tiles).float()
    c = count.double()
    print(f'water4096: live lines per (row water, cluster) slab: mean {float(c.mean()):.2f}, '
          f'p99 {float(torch.quantile(c, 0.99)):.0f}, max {int(count.max())} (runs of '
          f'{float(run.mean()):.1f} valid entries, max {int(run.max())}); all slabs '
          f'{int(count.sum())} lines, {int(count.sum()) * 2 * BS.WATER * BS.CLUSTER * 4 / 1e9:.3f} '
          f'GB of float32 s3/s5')
    assert int(count.sum()) == int(live.sum())
    assert int(count.max()) <= BS.default_line_capacity(sites.shape[0]) == n_tiles


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('name', sorted(SYSTEMS))
def test_line_twin_is_the_block_twin(k1_twins, name, variant):
    (sites, n, tiles, consts, box), (field, s3, s5) = _k1(k1_twins, name, variant)
    field_l, lines = _k1_lines(k1_twins, name, variant)
    live = BS.live_lines(sites[:, :3], n, tiles, box, consts.cutoff)
    assert lines.capacity == sites.shape[0] // BS.TILE
    assert torch.equal(lines.count, BS.line_slots(live, tiles)[1])
    assert not bool(lines.overflow())
    assert torch.equal(field_l, field)
    b3, b5 = BS.lines_to_blocks(lines, tiles)
    assert torch.equal(b3, s3) and torch.equal(b5, s5)
    # the lines of a slab are in list-entry order, each of its row tile
    stored = torch.arange(lines.capacity) < lines.count[..., None]
    entry = torch.where(stored, lines.entry, torch.iinfo(torch.int32).max)
    assert bool((entry[..., 1:] > entry[..., :-1])[stored[..., 1:]].all())
    water, _, _ = torch.nonzero(stored, as_tuple=True)
    assert torch.equal(tiles.ti[lines.entry[stored].long()].long(),
                       water // (BS.TILE // BS.WATER))
    back = BS.blocks_to_lines(s3, s5, tiles, live, lines.capacity)
    assert torch.equal(back.count, lines.count)
    for a, b in ((back.s3, lines.s3), (back.s5, lines.s5), (back.entry, lines.entry)):
        assert torch.equal(a[stored], b[stored])


@pytest.mark.parametrize('variant', VARIANTS)
@pytest.mark.parametrize('name', sorted(SYSTEMS))
def test_line_k3_twin_is_the_block_k3_twin(k1_twins, name, variant):
    (sites, n, tiles, consts, _), (_, s3, s5) = _k1(k1_twins, name, variant)
    _, lines = _k1_lines(k1_twins, name, variant)
    mu = torch.as_tensor(np.random.default_rng(11).normal(0.0, 0.01, (n, 3)))
    mu_pad = BS.pad_rows(mu, sites.shape[0])
    blocks = BS.scf_dipole_field_blocks_plain(sites, s3, s5, mu_pad, tiles, n, consts)
    assert torch.equal(BS.scf_dipole_field_bs(sites, lines, mu_pad, tiles, n, consts), blocks)


def test_tuned_line_capacity_holds_every_slab():
    """(f) at water1024 in block mode: tune_capacities' line capacity
    against the live lines of the tuned sort at the same positions."""
    system, pos = _system(SYSTEMS['water1024'])
    pot = MBPol(system, MBPolConfig(nonbonded_method='PME', cutoff=CUTOFF,
                                    electrostatics_mode='block', dispersion_mode='pairs'),
                device='cpu')
    n_tiles = BS.padded(pos.shape[0]) // BS.TILE
    assert pot._block_info['line_capacity'] == n_tiles           # untuned: never overflows
    pot.tune_capacities(pos)
    block = pot._block_info
    xyz = BS.pad_rows(pos[block['perm']], BS.padded(pos.shape[0]))
    tiles = BS.active_tile_pairs(xyz, pos.shape[0], system.box, CUTOFF,
                                 block['tile_pair_capacity'])
    _, count = BS.line_slots(BS.live_lines(xyz, pos.shape[0], tiles, system.box, CUTOFF), tiles)
    print(f'water1024: line capacity {block["line_capacity"]} of {n_tiles}, most live lines '
          f'of a slab {int(count.max())}')
    assert int(count.max()) <= block['line_capacity'] <= n_tiles
