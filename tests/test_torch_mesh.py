"""The port's device mesh (parallel/mesh.py) against the JAX package's, CPU
float64, with the port's shards on 'cpu' (make_mesh(devices=['cpu'] * 8))
and the JAX side on the conftest's 8 virtual host devices, on the 8-water
lattice of tests/test_multichip.py (box 0.94 nm, cutoff 0.45 nm; its 32
sites fill one tile, so 7 of 8 shards hold only padding).

- make_mesh's refusals; padded_for_mesh and row_ranges against JAX's
  arithmetic;
- the plain twins of the full-grid row kernels #3/#4, shard by shard,
  against JAX's fixed_field_and_scf_factors_sharded /
  direct_energy_force_pot_sharded in interpret mode (1e-9 of each
  output's max), and against the full dense twins of K1/K2 (1e-12);
- the sharded block wrappers (their plain twins on the CPU) against JAX's
  *_bs_sharded in interpret mode: the local tile lists entry for entry,
  the fixed field, the s3/s5 blocks, the SCF dipole field, the energy,
  forces and potential (1e-9 of each output's max);
- MBPol(mesh=) against the JAX MBPol(mesh=make_mesh(8)), dense, block and
  sparse (JAX's XLA formulas: the Pallas kernels run only under its
  interpret flag): energy rtol 1e-9, forces atol 1e-8 (the tolerances of
  tests/test_multichip.py);
- plan_capacities(n_devices=2, 4, 8): every integer field against JAX's
  planner, and MBPol(mesh=, plan=) against a potential tuned under the
  mesh.

The cluster path and the MD drivers under a mesh are in
tests/test_torch_mesh_md.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu.models import electrostatics as jelec
from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
from mbpol_openmm_plugin_tpu.ops import elec_pallas as EP
from mbpol_openmm_plugin_tpu.ops import elec_pallas_bs as JBS
from mbpol_openmm_plugin_tpu.parallel import mesh as JM
from mbpol_openmm_plugin_tpu.parallel.plan import plan_capacities as j_plan
from mbpol_openmm_plugin_tpu.system import System as JSystem
from mbpol_openmm_plugin_tpu.system import compute_virtual_sites as jvsites
from mbpol_openmm_plugin_tpu_torch.models import electrostatics as elec
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.ops import elec_direct as ED
from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as BS
from mbpol_openmm_plugin_tpu_torch.parallel import mesh as M
from mbpol_openmm_plugin_tpu_torch.parallel import plan as P
from mbpol_openmm_plugin_tpu_torch.system import System

torch.set_num_threads(1)

# rows against JAX's kernels in interpret mode: 1e-9 of each output's max
# (their erfc and H2 fits read <= 1.6e-10 of max in float64 on this input)
ROW_REL = 1e-9
E_RTOL, F_ATOL = 1e-9, 1e-8
CUTOFF = 0.45


def _lattice(n_side=2, spacing=0.47):
    """tests/test_multichip.py's lattice: positions [4n, 3] (M sites at the
    origin slot, placed later) and the box."""
    n = n_side ** 3
    pos = np.zeros((4 * n, 3))
    k = 0
    for i in range(n_side):
        for j in range(n_side):
            for m in range(n_side):
                o = np.array([i, j, m]) * spacing + 0.05
                pos[4 * k] = o
                pos[4 * k + 1] = o + [0.0757, 0.0586, 0.0]
                pos[4 * k + 2] = o + [-0.0757, 0.0586, 0.0]
                k += 1
    return pos, [n_side * spacing] * 3


@pytest.fixture(scope='module')
def lattice():
    """(JAX system, port system, positions with the M sites placed)."""
    pos, box = _lattice()
    jsys = JSystem.waters(8, box=box)
    pos = np.array(jvsites(jsys, jnp.asarray(pos)))
    return jsys, System.waters(8, box=box), pos


@pytest.fixture(scope='module')
def meshes():
    return M.make_mesh(devices=['cpu'] * 8), JM.make_mesh(8)


def _close(got, want, rel=ROW_REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.max(np.abs(got - want)) <= rel * np.max(np.abs(want)), \
        (np.max(np.abs(got - want)), np.max(np.abs(want)))


def _cfg(cls, **kw):
    return cls(nonbonded_method='PME', cutoff=CUTOFF, target_epsilon=1e-7, max_iterations=100,
               use_neighbor_lists=True, **kw)


@pytest.fixture(scope='module')
def direct_inputs(lattice):
    """The packed sites of both packages (JAX padded for the 8-shard mesh),
    the port's constants and a dipole set."""
    jsys, tsys, pos = lattice
    jpot = JMBPol(jsys, _cfg(JConfig))
    tpot = MBPol(tsys, _cfg(MBPolConfig), device='cpu')
    params = jpot.elec_params
    charges, _ = jelec.assemble_charges(params, jnp.asarray(pos))
    d16_inv = np.asarray(params.damping) ** (-1.0 / 6.0)
    n = pos.shape[0]
    n_pad = EP.padded_for_mesh(n, 8)
    srow = EP.pack_sites(jnp.asarray(pos), charges, jnp.asarray(d16_inv),
                         jnp.asarray(params.mol_index), jnp.asarray(params.atom_type == 0),
                         pad_to=n_pad)
    sites = ED.pack_sites(torch.as_tensor(pos), torch.as_tensor(np.array(charges)),
                          torch.as_tensor(d16_inv), torch.as_tensor(params.mol_index),
                          torch.as_tensor(params.atom_type == 0))
    consts = ED.DirectConsts.from_setup(tpot.pme, tpot.elec_params.thole)
    mu = 0.01 * np.sin(np.arange(3 * n, dtype=np.float64)).reshape(-1, 3)
    return dict(jpot=jpot, tpot=tpot, srow=srow, sites=sites, consts=consts, n=n, n_pad=n_pad,
                mu=mu, charges=np.array(charges), d16_inv=d16_inv, pos=pos)


# ----------------------------------------------------------------------
# the mesh and its arithmetic
# ----------------------------------------------------------------------

def test_make_mesh_refuses_missing_devices():
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match='visible'):
        M.make_mesh(visible + 1)
    with pytest.raises(ValueError):
        M.make_mesh(2, devices=['cpu'] * 3)
    mesh = M.make_mesh(devices=['cpu'] * 8)
    assert mesh.size == 8 and mesh.lead == torch.device('cpu') and mesh.axis == 'dp'
    assert mesh.distinct() == (torch.device('cpu'),) and not mesh.spans_devices


@pytest.mark.parametrize('n_dev', [1, 2, 4, 8])
def test_padding_and_row_ranges_match_jax(n_dev):
    mesh = M.make_mesh(devices=['cpu'] * n_dev)
    for n in (1, 32, 200, 1024, 1025, 4096, 16384):
        n_pad = M.padded_for_mesh(n, n_dev)
        assert n_pad == EP.padded_for_mesh(n, n_dev)
        local = n_pad // n_dev                  # JAX's shard_map row block
        assert M.row_ranges(n_pad, mesh) == [(k * local, (k + 1) * local)
                                             for k in range(n_dev)]
        ranges = M.row_ranges(n, mesh)
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert M.round_up(10, 4) == JM.round_up(10, 4) == 12


# ----------------------------------------------------------------------
# kernels #3/#4: the row twins shard by shard
# ----------------------------------------------------------------------

def test_k1_rows_twin_vs_jax_sharded_interpret(direct_inputs, meshes):
    w = direct_inputs
    _, jmesh = meshes
    n, n_pad = w['n'], w['n_pad']
    ef_j, s3_j, s5_j = EP.fixed_field_and_scf_factors_sharded(
        w['jpot'].pme, w['jpot'].elec_params.thole, w['srow'], n, jmesh, interpret=True)
    s3_j, s5_j = np.asarray(s3_j), np.asarray(s5_j)
    ef_full, s3_full, s5_full = ED.fixed_field_and_scf_factors_plain(w['sites'], w['consts'])
    local = n_pad // 8
    fields = []
    for k in range(8):
        f, s3, s5 = ED.fixed_field_and_scf_factors_rows(w['sites'], k * local, (k + 1) * local,
                                                        w['consts'], n_pad)
        assert s3.shape == (local, n_pad)
        _close(s3.numpy(), s3_j[k * local:(k + 1) * local])
        _close(s5.numpy(), s5_j[k * local:(k + 1) * local])
        fields.append(f)
        if k:      # padding-only shards: exact zeros
            assert not torch.any(s3) and not torch.any(s5) and not torch.any(f)
    field = torch.cat(fields)[:n]
    _close(field.numpy(), np.asarray(ef_j))
    # the same formulas as the full dense twin (and its rows), to the last bits
    np.testing.assert_allclose(field.numpy(), ef_full.numpy(), rtol=1e-12, atol=1e-12)
    s3_0 = ED.fixed_field_and_scf_factors_rows(w['sites'], 0, local, w['consts'], n_pad)[1]
    np.testing.assert_allclose(s3_0[:n, :n].numpy(), s3_full.numpy(), rtol=1e-12, atol=1e-12)


def test_k2_rows_twin_vs_jax_sharded_interpret(direct_inputs, meshes):
    w = direct_inputs
    _, jmesh = meshes
    n, n_pad = w['n'], w['n_pad']
    e_j, f_j, p_j = EP.direct_energy_force_pot_sharded(
        w['jpot'].pme, w['jpot'].elec_params.thole, w['srow'], jnp.asarray(w['mu']), n, jmesh,
        interpret=True)
    mu = torch.as_tensor(w['mu'])
    e_full, f_full, p_full = ED.direct_energy_force_pot_plain(w['sites'], mu, w['consts'])
    local = n_pad // 8
    rows = [ED.direct_energy_force_pot_rows(w['sites'], mu, k * local, (k + 1) * local,
                                            w['consts']) for k in range(8)]
    e_row, force, pot = (torch.cat(x)[:n] for x in zip(*rows))
    for e_k, f_k, p_k in rows[1:]:
        assert not torch.any(e_k) and not torch.any(f_k) and not torch.any(p_k)
    _close(float(torch.sum(e_row)), float(e_j))
    _close(force.numpy(), np.asarray(f_j))
    _close(pot.numpy(), np.asarray(p_j))
    np.testing.assert_allclose(float(torch.sum(e_row)), float(e_full), rtol=1e-12)
    np.testing.assert_allclose(force.numpy(), f_full.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(pot.numpy(), p_full.numpy(), rtol=1e-12, atol=1e-12)
    # the sharded caller gathers the same rows
    e_s, f_s, p_s = ED.direct_energy_force_pot_sharded(w['sites'], mu, w['consts'], meshes[0])
    assert torch.equal(f_s, force) and torch.equal(p_s, pot)


# ----------------------------------------------------------------------
# the block path under the mesh
# ----------------------------------------------------------------------

def test_block_sharded_vs_jax_sharded_interpret(direct_inputs, meshes):
    w = direct_inputs
    tmesh, jmesh = meshes
    n, n_pad = w['n'], w['n_pad']
    jpot, consts = w['jpot'], w['consts']
    cap_l = 8
    ti_j, tj_j, meta_j, nact_j = JBS.active_tile_pairs_sharded(
        w['srow'][:, :3], n, jpot.pme.box, CUTOFF, cap_l, jmesh)
    params = jpot.elec_params
    sites = BS.pack_sites(torch.as_tensor(w['pos']), torch.as_tensor(w['charges']),
                          torch.as_tensor(w['d16_inv']), torch.as_tensor(params.mol_index),
                          torch.as_tensor(params.atom_type == 0), pad_to=n_pad)
    tiles = BS.active_tile_pairs_sharded(sites[:, :3], n, consts.box, CUTOFF, cap_l, tmesh)
    for k, t in enumerate(tiles):
        sl = slice(k * cap_l, (k + 1) * cap_l)
        np.testing.assert_array_equal(t.ti.numpy(), np.asarray(ti_j)[sl])
        np.testing.assert_array_equal(t.tj.numpy(), np.asarray(tj_j)[sl])
        np.testing.assert_array_equal(t.meta.numpy(), np.asarray(meta_j)[sl])
        assert int(t.n_act) == int(np.asarray(nact_j)[k]) and t.row_tile0 == k
    assert [int(t.n_act) for t in tiles] == [1, 0, 0, 0, 0, 0, 0, 0]

    ef_j, s3_j, s5_j = JBS.fixed_field_and_scf_blocks_sharded(
        jpot.pme, params.thole, w['srow'], n, ti_j, tj_j, meta_j, jmesh, interpret=True)
    field, lines = BS.fixed_field_and_scf_lines_sharded(sites, n, tiles, consts, None, tmesh)
    _close(field.numpy(), np.asarray(ef_j))
    for k, (t, ln) in enumerate(zip(tiles, lines)):
        b3, b5 = BS.lines_to_blocks(ln, t)
        valid = (t.meta.numpy() & BS.VALID) > 0
        if not valid.any():      # a padding-only shard stores no line
            assert not bool(ln.count.any())
            continue
        sl = slice(k * cap_l, (k + 1) * cap_l)
        _close(b3.numpy()[valid], np.asarray(s3_j)[sl][valid])
        _close(b5.numpy()[valid], np.asarray(s5_j)[sl][valid])

    mp = jnp.zeros((n_pad, EP._NS)).at[:n, :3].set(jnp.asarray(w['mu']))
    f_j = JBS.scf_dipole_field_bs_sharded(jpot.pme, params.thole, w['srow'], s3_j, s5_j, mp,
                                          ti_j, tj_j, meta_j, n, jmesh, interpret=True)
    mu = torch.as_tensor(w['mu'])
    f_t = BS.scf_dipole_field_bs_sharded(sites, lines, BS.pad_rows(mu, n_pad), tiles, n,
                                         consts, tmesh)
    _close(f_t.numpy(), np.asarray(f_j))
    # the lines hold the dense twin's s3/s5: the SCF field of the dense formulas
    _, s3, s5 = ED.fixed_field_and_scf_factors_plain(w['sites'], consts)
    dense = elec.dipole_field(mu, s3, s5, ED.pair_delta(w['sites'][:, :3], consts.box))
    np.testing.assert_allclose(f_t.numpy(), dense.numpy(), rtol=1e-12, atol=1e-12)

    e_j, fo_j, p_j = JBS.direct_energy_force_pot_bs_sharded(
        jpot.pme, params.thole, w['srow'], jnp.asarray(w['mu']), n, ti_j, tj_j, meta_j, jmesh,
        interpret=True)
    e_t, fo_t, p_t = BS.direct_energy_force_pot_bs_sharded(sites, mu, n, tiles, consts, tmesh)
    _close(float(e_t), float(e_j))
    _close(fo_t.numpy(), np.asarray(fo_j))
    _close(p_t.numpy(), np.asarray(p_j))
    e_d, fo_d, p_d = ED.direct_energy_force_pot_plain(w['sites'], mu, consts)
    np.testing.assert_allclose(float(e_t), float(e_d), rtol=1e-12)
    np.testing.assert_allclose(fo_t.numpy(), fo_d.numpy(), rtol=1e-12, atol=1e-12)


# ----------------------------------------------------------------------
# MBPol(mesh=) against the JAX MBPol under its mesh
# ----------------------------------------------------------------------

@pytest.mark.parametrize('mode', ['dense', 'block', 'sparse'])
def test_mbpol_mesh_vs_jax_mesh(lattice, meshes, mode):
    jsys, tsys, pos = lattice
    tmesh, jmesh = meshes
    os.environ.pop('MBPOL_ELEC_PALLAS', None)
    jpot = JMBPol(jsys, _cfg(JConfig, electrostatics_mode=mode), mesh=jmesh)
    if mode == 'block':
        jpot.tune_capacities(jnp.asarray(pos))
    with jmesh:
        e_j, f_j, parts_j, _ = jpot.energy_forces(jnp.asarray(pos))
        jax.block_until_ready(f_j)
    pot = MBPol(tsys, _cfg(MBPolConfig, electrostatics_mode=mode), mesh=tmesh)
    if mode == 'block':
        pot.tune_capacities(pos)
        assert pot._block_info['tile_pair_capacity_local'] is not None
    assert pot.device == torch.device('cpu') and pot.pair_cap % 8 == 0
    e, f, parts, diag = pot.energy_forces(pos)
    assert bool(diag['converged'])
    np.testing.assert_allclose(float(e), float(e_j), rtol=E_RTOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), atol=F_ATOL)
    for k in parts_j:
        np.testing.assert_allclose(float(parts[k]), float(parts_j[k]), rtol=E_RTOL, atol=1e-10)
    if mode == 'block':
        assert not bool(diag['elec_tile_overflow']) and int(diag['elec_tile_pairs']) >= 1


# ----------------------------------------------------------------------
# the planner for meshes
# ----------------------------------------------------------------------

INT_FIELDS = ('n_waters', 'n_devices', 'pair_cap', 'trip_cap', 'pair_eval_cap',
              'trip_eval_cap', 'nlist_k_max', 'nlist_kt', 'elec_pair_cap', 'disp_pair_cap',
              'tile_pair_capacity_local')
BOX256 = [19.3996888399961804 / 10.0] * 3


@pytest.fixture(scope='module')
def water256():
    _, jpos = fixtures.load_system('water256_integration_test', box=BOX256)
    return np.array(jpos)


@pytest.mark.parametrize('n_dev', [2, 4, 8])
@pytest.mark.parametrize('exact', [False, True])
@pytest.mark.parametrize('mode', ['dense', 'sparse', 'block'])
def test_plan_fields_match_jax_for_meshes(water256, n_dev, exact, mode):
    kw = dict(nonbonded_method='PME', cutoff=0.9, nlist_skin=0.05, electrostatics_mode=mode,
              compact_eval='rebuild')
    positions = water256 if exact else None
    jp = j_plan(256, BOX256, n_devices=n_dev, config=JConfig(**kw), positions=positions,
                pallas_ok=False)
    tp = P.plan_capacities(256, BOX256, n_devices=n_dev, config=MBPolConfig(**kw),
                           positions=positions, device='cpu')
    for name in INT_FIELDS:
        if mode == 'block' and exact and name == 'tile_pair_capacity_local':
            continue         # the port's block layout: checked against tune_capacities below
        assert getattr(tp, name) == getattr(jp, name), name
    assert tp.per_device() == {k: v for k, v in jp.per_device().items()}
    assert (tp.elec_mode, tp.disp_mode, tp.pme_grid) == (jp.elec_mode, jp.disp_mode, jp.pme_grid)
    assert f'per device: pair_rows={tp.pair_cap // n_dev}' in tp.describe()


def test_plan_for_a_mesh_equals_tuned_meshed_potential(water256):
    d = fixtures.load('water256_integration_test')
    tsys = System.from_atom_names(d['names'], d['resnames'], box=BOX256)
    mesh = M.make_mesh(devices=['cpu'] * 4)
    cfg = MBPolConfig.for_dynamics(electrostatics_mode='block', dispersion_mode='pairs')
    plan = P.plan_capacities(256, BOX256, n_devices=4, config=cfg, positions=water256,
                             device='cpu')
    tuned = MBPol(tsys, cfg, mesh=mesh).tune_capacities(water256)
    planned = MBPol(tsys, cfg, mesh=mesh, plan=plan)
    info, pinfo = tuned._block_info, planned._block_info
    assert plan.tile_pair_capacity_local == info['tile_pair_capacity_local'] \
        == pinfo['tile_pair_capacity_local']
    np.testing.assert_array_equal(pinfo['site_perm'], info['site_perm'])
    for name in ('pair_cap', 'trip_cap', 'nlist_k_max', 'nlist_kt', 'disp_pair_cap'):
        assert getattr(planned, name) == getattr(tuned, name), name
        assert getattr(tuned, name) % 4 == 0 or name in ('nlist_k_max', 'nlist_kt')
    with pytest.raises(ValueError, match='devices'):
        MBPol(tsys, cfg, mesh=M.make_mesh(devices=['cpu'] * 2), plan=plan)
