"""The port's binding of the host voxel-hash neighbor lists (ops/native.py)
and its users (MBPol.tune_capacities(native=True),
MBPol.build_neighbor_lists(use_native=True)), CPU float64.

- pair and triplet lists against brute force, periodic and not (the cases
  of tests/test_native.py), and against the JAX package's binding of the
  same source, exactly;
- the library is built into the port's _build/, keyed on the source;
- without g++ on PATH the build raises, and tune_capacities(native=True)
  with it: nothing falls back;
- tune_capacities(native=True) gives the torch counts' capacities, and the
  native lists padded on the device give the device lists' energy;
- the native build refuses to run inside an MD step.
"""
import os

import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu.ops import native as jnative
from mbpol_openmm_plugin_tpu.system import make_molecules_whole
from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.ops import _build
from mbpol_openmm_plugin_tpu_torch.ops import native
from mbpol_openmm_plugin_tpu_torch.system import System
from test_neighbors import _brute_force_lists

torch.set_num_threads(1)

BOX256 = [19.3996888399961804 / 10.0] * 3


def _o(periodic):
    box = [1.8] * 3 if periodic else None
    sys_, pos = fixtures.load_system('water50', box=box)
    if periodic:
        pos = make_molecules_whole(sys_, pos)
    return np.asarray(pos[sys_.o_index]), box


@pytest.mark.parametrize('periodic', [True, False])
def test_native_lists_match_brute_force(periodic):
    o, box = _o(periodic)
    for cutoff in (0.45, 0.65):
        bf_pairs, bf_trips = _brute_force_lists(o, box, cutoff)
        pairs, n_p = native.pair_list(o, box, cutoff)
        assert n_p == len(bf_pairs) and pairs.dtype == np.int32
        assert {tuple(p) for p in pairs} == set(bf_pairs)
        trips, n_t = native.triplet_list(o, box, cutoff)
        assert n_t == len(bf_trips)
        assert {tuple(sorted(t)) for t in trips} == {tuple(t) for t in bf_trips}


@pytest.mark.parametrize('periodic', [True, False])
def test_native_lists_equal_the_jax_binding(periodic):
    o, box = _o(periodic)
    for cutoff in (0.45, 0.65, 1.15):
        for fn in ('pair_list', 'triplet_list'):
            got, n = getattr(native, fn)(o, box, cutoff, capacity=4000)
            want, n_j = getattr(jnative, fn)(o, box, cutoff, capacity=4000)
            assert n == n_j
            np.testing.assert_array_equal(got, want)


def test_native_scales_and_truncates_at_capacity():
    rng = np.random.default_rng(0)
    n = 4096
    box = [8.0] * 3
    o = rng.uniform(0, 8.0, size=(n, 3))
    pairs, n_p = native.pair_list(o, box, 0.65, capacity=n * 64)
    trips, n_t = native.triplet_list(o, box, 0.45, capacity=n * 256)
    assert n_p == len(pairs) > 0 and n_t == len(trips) > 0
    d = o[pairs[:, 0]] - o[pairs[:, 1]]
    d -= np.floor(d / 8.0 + 0.5) * 8.0
    assert np.all(np.linalg.norm(d, axis=1) < 0.65)
    short, found = native.pair_list(o, box, 0.65, capacity=100)
    assert len(short) == 100 and found == n_p


def test_library_lands_in_the_ports_build_dir():
    path = native.build()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith('libmbpol_native_') and os.path.exists(path)
    assert path == native.library_path()
    assert os.path.dirname(native.SOURCE) == os.path.join(os.path.dirname(_build.PKG_DIR),
                                                          'native')


def test_without_gxx_the_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, 'BUILD_DIR', str(tmp_path))
    monkeypatch.setenv('PATH', str(tmp_path))
    native._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match='g\\+\\+'):
            native.pair_list(np.zeros((3, 3)), [1.8] * 3, 0.45)
        d = fixtures.load('water50')
        tsys = System.from_atom_names(d['names'], d['resnames'], box=[1.8] * 3)
        pot = MBPol(tsys, MBPolConfig.for_dynamics(), device='cpu')
        with pytest.raises(RuntimeError, match='g\\+\\+'):
            pot.tune_capacities(np.array(d['positions']), native=True)
        assert os.listdir(tmp_path) == []
    finally:
        native._lib.cache_clear()


@pytest.fixture(scope='module')
def water256():
    d = fixtures.load('water256_integration_test')
    tsys = System.from_atom_names(d['names'], d['resnames'], box=BOX256)
    return tsys, np.array(d['positions'])


@pytest.mark.parametrize('mode', ['sparse', 'block'])
def test_native_tuning_equals_the_torch_counts(water256, mode):
    tsys, pos = water256
    cfg = MBPolConfig.for_dynamics(electrostatics_mode=mode, dispersion_mode='pairs',
                                   compact_eval=True)
    a = MBPol(tsys, cfg, device='cpu').tune_capacities(pos)
    b = MBPol(tsys, cfg, device='cpu').tune_capacities(pos, native=True)
    for name in ('pair_cap', 'trip_cap', 'pair_eval_cap', 'trip_eval_cap', 'nlist_k_max',
                 'nlist_kt', 'elec_pair_cap', 'disp_pair_cap'):
        assert getattr(a, name) == getattr(b, name), name
    if mode == 'block':
        for k in ('tile_pair_capacity', 'line_capacity'):
            assert a._block_info[k] == b._block_info[k]
        np.testing.assert_array_equal(a._block_info['site_perm'], b._block_info['site_perm'])


def test_native_neighbor_lists(water256):
    from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
    from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
    jsys, jpos = fixtures.load_system('water256_integration_test', box=BOX256)
    tsys, pos = water256
    jpot = JMBPol(jsys, JConfig.for_dynamics())
    (jpl, jtl), jd = jpot._build_neighbor_lists_native(jpos)
    pot = MBPol(tsys, MBPolConfig.for_dynamics(), device='cpu')
    (pl, tl), d = pot.build_neighbor_lists(pos, use_native=True)
    for got, want in zip((*pl, *tl), (*jpl, *jtl)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for k in ('n_pairs', 'n_triplets', 'pair_overflow', 'triplet_overflow'):
        assert int(d[k]) == int(jd[k]), k
    e_n = pot._energy_forces_impl(pos, nlists=(pl, tl))[0]
    e_d = pot._energy_forces_impl(pos)[0]
    assert abs(float(e_n) - float(e_d)) <= 1e-9 * abs(float(e_d))
    with pytest.raises(ValueError, match='complete'):
        MBPol(tsys, MBPolConfig.for_dynamics(triplet_semantics='reference'),
              device='cpu').build_neighbor_lists(pos, use_native=True)


def test_native_lists_refuse_the_md_step(monkeypatch):
    d = fixtures.load('water50')
    tsys = System.from_atom_names(d['names'], d['resnames'], box=[1.8] * 3)
    pot = MBPol(tsys, MBPolConfig.for_dynamics(cutoff=0.85), device='cpu')
    build = MBPol.build_neighbor_lists
    monkeypatch.setattr(MBPol, 'build_neighbor_lists',
                        lambda self, p, box=None: build(self, p, box, use_native=True))
    sim = Simulation(pot, SimulationConfig(dt=0.0002, nlist_rebuild_interval='auto'))
    sim.set_positions(np.array(d['positions']))
    with pytest.raises(RuntimeError, match='outside the MD step'):
        sim.step(2)
