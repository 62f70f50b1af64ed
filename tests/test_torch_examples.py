"""The port's example applications and validation tools
(mbpol_openmm_plugin_tpu_torch/examples/, tools/bulk_validation.py,
tools/respa_drift.py) against the JAX package's scripts, CPU float64.

- no example or tool imports jax or the JAX package; each raises without a
  card unless given the CPU, and make_inputs writes the PDBs of
  examples/make_inputs.py byte for byte;
- MBPol.energy: bit for bit energy_forces(...)[0], and within 1e-9
  relative of the JAX MBPol.energy on water50;
- ir_spectrum (examples/ir_spectrum.py:54-71): the water14 cluster from the
  example PDB, 12 NVE steps in calls of 2 from fixed velocities through a
  second Simulation given the first one's state, against the JAX
  Simulation doing the same: frames 1e-10 nm, the dipole series and the IR
  lineshape 1e-8 relative; the Langevin start is left out (the port draws
  its noise from a torch.Generator, the JAX script from its key);
- bulk_properties (examples/bulk_properties.py:71-133): water50 (box 1.8
  nm, cutoff 0.85 nm), 6 NVE steps in calls of 2, frames every 2: frames
  and velocities 1e-10, every observable 1e-8 relative against the JAX
  analysis calls of the script;
- remd_water14 (examples/remd_water14.py:92-100): MBAR free energies and
  the reweighted <U>(T) grid on one seeded u_kn, 1e-8 relative;
- tools/bulk_validation.py and tools/respa_drift.py: the JAX tool's main()
  and the port's run() on one fixed series (a stand-in Simulation and
  MBPol on both sides, the same boxes, frames and energies): the density,
  its spread, the centroid rescale onto the mean box (the JAX tool's
  float32 handover bit for bit), g_OO, D,
  the drift, every band verdict; and respa_drift's fit.
"""
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu import analysis as janalysis
from mbpol_openmm_plugin_tpu.md.simulation import Simulation as JSimulation
from mbpol_openmm_plugin_tpu.md.simulation import SimulationConfig as JSimConfig
from mbpol_openmm_plugin_tpu.models import electrostatics as jelec
from mbpol_openmm_plugin_tpu.models.potential import MBPol as JMBPol
from mbpol_openmm_plugin_tpu.models.potential import MBPolConfig as JConfig
from mbpol_openmm_plugin_tpu.system import System as JSystem
from mbpol_openmm_plugin_tpu.system import compute_virtual_sites as jvsites
from mbpol_openmm_plugin_tpu.system import make_molecules_whole as jwhole
from mbpol_openmm_plugin_tpu_torch import analysis
from mbpol_openmm_plugin_tpu_torch.examples import (_common, bulk_properties, ir_spectrum,
                                                    make_inputs, remd_water14)
from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation, SimulationConfig
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.system import System
from mbpol_openmm_plugin_tpu_torch.tools import bulk_validation, respa_drift
from mbpol_openmm_plugin_tpu_torch.utils import cli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, 'mbpol_openmm_plugin_tpu_torch')
ENTRY_POINTS = ('water14', 'example_nvt_nve', 'make_inputs', 'ir_spectrum', 'bulk_properties',
                'water14_pimd', 'water256_pimd', 'isotope_density', 'remd_water14',
                'water2048_scaling', 'multichip_scaling')
TOOLS = ('bulk_validation', 'respa_drift', 'nve_drift')
# argv that reach the device check of each entry point without a card
CARD_ARGV = {'water14': [], 'example_nvt_nve': [], 'ir_spectrum': ['2'],
             'bulk_properties': ['2'], 'water14_pimd': ['2', '2'], 'water256_pimd': ['2'],
             'isotope_density': ['2'], 'remd_water14': ['1'], 'water2048_scaling': ['2048'],
             'multichip_scaling': ['512', '2'], 'bulk_validation': [], 'respa_drift': [],
             'nve_drift': ['--steps', '2']}
BOX50 = 1.8
W50 = dict(nonbonded_method='PME', cutoff=0.85, target_epsilon=1e-3, max_iterations=200,
           nlist_skin=0.02)


def _module(name):
    pkg = 'tools' if name in TOOLS else 'examples'
    return importlib.import_module(f'mbpol_openmm_plugin_tpu_torch.{pkg}.{name}')


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _velocities(system, seed, temperature=300.0):
    """Maxwell-Boltzmann-like velocities from a seeded numpy generator, zero
    on the massless sites."""
    m = np.asarray(system.masses)
    kT = 0.00831446261815324 * temperature
    v = np.random.default_rng(seed).normal(size=(len(m), 3))
    return np.where(m[:, None] > 0, v * np.sqrt(kT / np.where(m > 0, m, 1.0))[:, None], 0.0)


@pytest.fixture
def jit_moments(monkeypatch):
    """The JAX system_moments as one compiled program per frame shape (op by
    op it takes several times longer)."""
    moments = jelec.system_moments
    monkeypatch.setattr(jelec, 'system_moments', lambda params, pos, masses: jax.jit(
        lambda p: moments(params, p, masses))(pos))


# ----------------------------------------------------------------------
# the package: names, imports, device
# ----------------------------------------------------------------------

def test_entry_points_import_neither_jax_nor_the_jax_package():
    bad = re.compile(r'^\s*(import jax|from jax|import mbpol_openmm_plugin_tpu\b(?!_torch)|'
                     r'from mbpol_openmm_plugin_tpu(\.| )(?!.*_torch))', re.M)
    paths = [os.path.join(PORT, 'examples', f'{n}.py') for n in ENTRY_POINTS + ('_common',
                                                                             '__init__')]
    paths += [os.path.join(PORT, 'tools', f'{n}.py') for n in TOOLS]
    paths.append(os.path.join(PORT, 'utils', 'cli.py'))
    for path in paths:
        with open(path) as fh:
            src = fh.read()
        assert not bad.search(src), path
        assert 'mbpol_openmm_plugin_tpu.' not in src.replace('mbpol_openmm_plugin_tpu_torch', '')
    for name in ENTRY_POINTS + TOOLS:
        mod = _module(name)
        assert callable(mod.main) and callable(mod.run), name


@pytest.mark.parametrize('name', sorted(CARD_ARGV))
def test_entry_point_raises_without_a_card(name):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        _module(name).main(CARD_ARGV[name])


def test_make_inputs_writes_the_example_pdbs(tmp_path):
    """The JAX script's writer (examples/make_inputs.py:19-26) over the same
    fixtures: the same bytes."""
    from mbpol_openmm_plugin_tpu.app.pdbfile import Atom, Topology, write_pdb_frame
    paths = make_inputs.run(str(tmp_path), echo=False)
    assert sorted(paths) == sorted(_common.PDBS)
    for name, path in paths.items():
        d = fixtures.load(name)
        atoms = [Atom(i, str(n), str(rn), int(ri)) for i, (n, rn, ri) in
                 enumerate(zip(d['names'], d['resnames'], d['resids']))]
        buf = io.StringIO()
        write_pdb_frame(buf, Topology(atoms), d['positions'])
        with open(path) as fh:
            assert fh.read() == buf.getvalue(), name


# ----------------------------------------------------------------------
# MBPol.energy
# ----------------------------------------------------------------------

def test_energy_matches_energy_forces_and_jax():
    d = fixtures.load('water50')
    jsys = JSystem.from_atom_names(d['names'], d['resnames'], box=[BOX50] * 3)
    pos = np.asarray(jvsites(jsys, jwhole(jsys, jnp.asarray(d['positions']))))
    cfg = dict(W50, target_epsilon=1e-10, max_iterations=500)
    pot = MBPol(System.from_atom_names(d['names'], d['resnames'], box=[BOX50] * 3),
                MBPolConfig(**cfg), device='cpu')
    e = pot.energy(pos)
    assert e.shape == () and e.dtype == torch.float64
    assert float(e) == float(pot.energy_forces(pos)[0])
    je = float(JMBPol(jsys, JConfig(**cfg)).energy(jnp.asarray(pos)))
    assert abs(float(e) - je) <= 1e-9 * abs(je)


# ----------------------------------------------------------------------
# ir_spectrum and bulk_properties: NVE in short calls, then the analysis
# ----------------------------------------------------------------------

def _jax_frames(jpot, pos, vel, n_calls, every):
    """The JAX scripts' production loop (ir_spectrum.py:57-63,
    bulk_properties.py:71-77): a second Simulation over the potential given
    the state, stepped `every` steps per call."""
    jsim = JSimulation(jpot, JSimConfig(dt=2e-4, temperature=None))
    jsim.set_positions(jnp.asarray(pos))
    jsim.state = dataclasses.replace(jsim.state, velocities=jnp.asarray(vel))
    frames, vels = [], []
    for _ in range(n_calls):
        jsim.step(every)
        frames.append(np.asarray(jsim.state.positions))
        vels.append(np.asarray(jsim.state.velocities))
    return np.asarray(frames), np.asarray(vels)


def _port_state(pot, pos, vel):
    sim = Simulation(pot, SimulationConfig(dt=2e-4, temperature=None))
    sim.set_positions(pos)
    return dataclasses.replace(sim.state, velocities=torch.as_tensor(vel))


def test_ir_spectrum_matches_jax(tmp_path, jit_moments):
    from mbpol_openmm_plugin_tpu import app as japp
    pot, pos = ir_spectrum.potential('cpu', pdb_dir=str(tmp_path))
    pdb = japp.PDBFile(os.path.join(str(tmp_path), 'water14_cluster.pdb'))
    jsys = JSystem.waters(14)
    jpos = jvsites(jsys, jnp.asarray(pdb.positions.to_internal()))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    vel = _velocities(pot.system, 14)
    n_steps, every = 12, ir_spectrum.FRAME_EVERY
    jpot = JMBPol(jsys, JConfig(nonbonded_method='NoCutoff', target_epsilon=1e-5))
    jframes, _ = _jax_frames(jpot, jpos, vel, n_steps // every, every)
    frames, sim_nve, _ = ir_spectrum.production(pot, _port_state(pot, pos, vel), n_steps)
    assert frames.shape == jframes.shape and sim_nve.state.step == n_steps
    assert np.max(np.abs(frames - jframes)) <= 1e-10
    jmu = janalysis.dipole_series(jpot, jframes)
    mu = analysis.dipole_series(pot, frames)
    assert _rel(mu, jmu) <= 1e-8
    jf, ji = janalysis.infrared_spectrum(jmu, dt=ir_spectrum.DT * every)
    f, i = analysis.infrared_spectrum(mu, dt=ir_spectrum.DT * every)
    np.testing.assert_allclose(f, jf, rtol=1e-12)
    assert _rel(i / i.max(), ji / ji.max()) <= 1e-8
    assert ir_spectrum.bands(f, i / i.max()).keys() <= {b[2] for b in _common.BANDS}


def test_bulk_properties_matches_jax(jit_moments):
    d = fixtures.load('water50')
    box = [BOX50] * 3
    jsys = JSystem.from_atom_names(d['names'], d['resnames'], box=box)
    jpos = jvsites(jsys, jwhole(jsys, jnp.asarray(d['positions'])))
    sys_ = System.from_atom_names(d['names'], d['resnames'], box=box)
    pot = MBPol(sys_, MBPolConfig(**W50), device='cpu')
    pot.tune_capacities(np.asarray(jpos))
    jpot = JMBPol(jsys, JConfig(**W50))
    jpot.tune_capacities(jpos)
    vel = _velocities(sys_, 50)
    n_frames, every = 3, 2
    jframes, jvels = _jax_frames(jpot, jpos, vel, n_frames, every)
    frames, vels, _, _ = bulk_properties.production(pot, _port_state(pot, np.asarray(jpos), vel),
                                                    n_frames, frame_every=every)
    assert np.max(np.abs(frames - jframes)) <= 1e-10
    assert np.max(np.abs(vels - jvels)) <= 1e-10
    dt_frame = every * bulk_properties.DT
    obs = bulk_properties.observables(sys_, pot, frames, vels, dt_frame, box,
                                      structure_every=1, dipole_every=1)
    # the script's calls (bulk_properties.py:88-123), on the JAX frames
    ref = {}
    ref['rdf_r'], ref['rdf_g'] = janalysis.radial_distribution(jsys, jframes, species='OO')
    ref['sq_q'], ref['sq_s'] = janalysis.static_structure_factor(jsys, jframes, q_max=40.0)
    ref['hbonds_per_molecule'] = 2.0 * janalysis.hydrogen_bonds(jsys, jframes).mean() / 50
    ref['tetrahedral_order'] = janalysis.tetrahedral_order(jsys, jframes).mean()
    ref['msd_t'], ref['msd'] = janalysis.mean_squared_displacement(jsys, jframes, dt_frame,
                                                                    species='com')
    with pytest.raises(ValueError, match='fit window'):
        # 3 frames: too short for the Einstein fit (the script prints so)
        janalysis.diffusion_coefficient(ref['msd_t'], ref['msd'])
    ref['gk_t'], ref['gk_d'] = janalysis.diffusion_coefficient_gk(jsys, jvels, dt_frame,
                                                                  species='com')
    ref['dipoles'] = janalysis.dipole_series(jpot, jframes)
    ref['epsilon'] = janalysis.static_dielectric(ref['dipoles'], box, bulk_properties.T)
    ref['vdos_freq'], ref['vdos'] = janalysis.vibrational_density_of_states(jsys, jvels,
                                                                            dt_frame)
    assert obs['d_einstein_nm2_ps'] is None and obs['epsilon'] > 1.0
    for k, v in ref.items():
        assert np.all(np.isfinite(obs[k])), k
        assert _rel(obs[k], v) <= 1e-8, k
    k = int(np.argmax(ref['rdf_g']))
    assert (obs['g_oo_peak_nm'], obs['g_oo_peak_height']) == (ref['rdf_r'][k], ref['rdf_g'][k])


# ----------------------------------------------------------------------
# remd_water14: MBAR
# ----------------------------------------------------------------------

def test_remd_mbar_matches_jax():
    temps = np.geomspace(250.0, 450.0, 4)
    rng = np.random.default_rng(17)
    u_kn = (-300.0 + 0.12 * (temps[:, None] - 250.0)
            + rng.normal(scale=np.sqrt(temps)[:, None] * 0.2, size=(4, 30)))
    f, grid = remd_water14.mbar(u_kn, temps, 7)
    jf = janalysis.mbar_free_energies(u_kn, temps)
    assert _rel(f, jf) <= 1e-8
    for t, u, n_eff in grid:
        w = janalysis.mbar_reweight(u_kn, temps, t, f=jf, observable=u_kn)
        assert abs(u - w['mean']) <= 1e-8 * abs(w['mean'])
        assert abs(n_eff - w['n_eff']) <= 1e-8 * w['n_eff']


# ----------------------------------------------------------------------
# the validation tools on a fixed series
# ----------------------------------------------------------------------

def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f'jax_tool_{name}',
                                                  os.path.join(REPO, 'tools', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Series:
    """What a stand-in Simulation reads: per step() call, in call order, the
    box, the positions, the velocities and the last total energy."""

    def __init__(self, n_calls, seed=23):
        pos = fixtures.load('water256_integration_test')['positions']
        rng = np.random.default_rng(seed)
        mol = np.repeat(np.arange(256), 4)
        drift = rng.normal(scale=0.004, size=(n_calls, 256, 3)).cumsum(axis=0)
        self.positions = pos[None] + drift[:, mol]
        self.velocities = rng.normal(scale=0.5, size=(n_calls,) + pos.shape)
        self.boxes = cli.BOX256 * (1.0 + rng.uniform(-0.01, 0.01, size=n_calls))[:, None] \
            * np.ones(3)
        self.energies = -9400.0 + 0.8 * np.arange(n_calls) + rng.normal(scale=0.3,
                                                                         size=n_calls)
        self.calls = 0
        self.set_positions = []


def _fake_simulation(series, wrap):
    """A Simulation stand-in over `series` whose state holds `wrap`(array)
    (jnp or torch arrays)."""
    @dataclasses.dataclass
    class State:
        positions: object
        velocities: object
        box: object

    class FakeSimulation:
        def __init__(self, potential, config=None, seed=0, **kw):
            self.config = config
            self.capture_ms = []
            self.state = None

        def set_positions(self, positions, box=None):
            p = np.array(positions.detach().numpy() if hasattr(positions, 'detach')
                         else positions, np.float64)
            series.set_positions.append(p)
            self.state = State(wrap(p), wrap(np.zeros_like(p)), np.array(self._box(0)))

        def _box(self, k):
            return series.boxes[min(k, len(series.boxes) - 1)]

        def set_velocities_to_temperature(self, t):
            pass

        def step(self, n, report_interval=None, check_health=True):
            k = series.calls
            series.calls += 1
            self.state = State(wrap(series.positions[k]), wrap(series.velocities[k]),
                               np.array(self._box(k)))
            return dict(total_energy=np.array([series.energies[k]]), barostat_attempted=0,
                        barostat_accepted=0)
    return FakeSimulation


class _FakePot:
    def __init__(self, system, config=None, device=None, **kw):
        self.system = system

    def tune_capacities(self, positions, margin=1.15):
        return self

    def as_positions(self, positions):
        return torch.as_tensor(np.asarray(positions), dtype=torch.float64)


@contextlib.contextmanager
def _jax_tool_stand_ins(monkeypatch, series):
    import mbpol_openmm_plugin_tpu.md.simulation as jsim_mod
    import mbpol_openmm_plugin_tpu.models.potential as jpot_mod
    monkeypatch.setattr(jax.config, 'update', lambda *a, **k: None)
    monkeypatch.setattr(jsim_mod, 'Simulation', _fake_simulation(series, jnp.asarray))
    monkeypatch.setattr(jpot_mod, 'MBPol', _FakePot)
    yield


@contextlib.contextmanager
def _port_tool_stand_ins(monkeypatch, series):
    import mbpol_openmm_plugin_tpu_torch.md.simulation as sim_mod
    import mbpol_openmm_plugin_tpu_torch.models.potential as pot_mod
    monkeypatch.setattr(sim_mod, 'Simulation', _fake_simulation(series, torch.as_tensor))
    monkeypatch.setattr(pot_mod, 'MBPol', _FakePot)
    yield


def _run_main(mod, argv, monkeypatch):
    monkeypatch.setattr('sys.argv', [mod.__file__] + argv)
    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out):
        try:
            mod.main()
        except SystemExit as e:
            code = e.code
    return json.loads(out.getvalue().strip().splitlines()[-1]), code


def test_bulk_validation_matches_the_jax_tool(monkeypatch):
    """--npt-eq-ps 0.1 --npt-ps 1.5 --nve-ps 0.2 --frame-every 100: one
    equilibration call, 3 NPT segments, the settle, 10 frames."""
    args = dict(npt_ps=1.5, nve_ps=0.2, npt_eq_ps=0.1, frame_every=100)
    argv = ['--npt-ps', '1.5', '--nve-ps', '0.2', '--npt-eq-ps', '0.1', '--frame-every', '100']
    n_calls = 1 + 3 + 1 + 10
    jseries = _Series(n_calls)
    with _jax_tool_stand_ins(monkeypatch, jseries):
        ref, jcode = _run_main(_jax_tool('bulk_validation'), argv, monkeypatch)
    series = _Series(n_calls)
    with _port_tool_stand_ins(monkeypatch, series):
        out = bulk_validation.run(device='cpu', echo=False, **args)
    assert jseries.calls == series.calls == n_calls
    # the production starts from the NPT end state, centroids scaled onto the
    # cube of the second half's mean volume
    # (the JAX tool hands them over in float32)
    np.testing.assert_array_equal(series.set_positions[1].astype(np.float32),
                                  jseries.set_positions[1])
    vols = np.prod(series.boxes[1:4], axis=1)
    L = float(vols[1:].mean() ** (1.0 / 3.0))
    sys_ = System.waters(256, box=[cli.BOX256] * 3)
    again = bulk_validation.centroid_rescale(sys_, series.positions[3], series.boxes[3][0], L)
    np.testing.assert_array_equal(again, series.set_positions[1])
    rho, sd, _ = bulk_validation.npt_density(256, vols)
    assert (rho, sd) == (out['density_g_cm3'], out['density_sd'])
    for key, nd in (('density_g_cm3', 4), ('density_sd', 4), ('g_oo_first_peak_nm', 4),
                    ('g_oo_first_peak_height', 3), ('production_drift_K_per_ns', 1)):
        assert round(out[key], nd) == ref[key], key
    assert float(f'{out["d_self_cm2_s"]:.3e}') == ref['d_self_cm2_s']
    assert out['band_ok'] == ref['band_ok'] and out['all_ok'] == ref['all_ok']
    assert out['bands'] == ref['bands'] and out['protocol']['frames'] == 10
    assert jcode == (0 if ref['all_ok'] else 1)
    # each band's verdict flips at its edges
    vals = dict(density=1.0, g_oo_peak_r=0.28, g_oo_peak_h=3.0, d_self_cm2_s=2e-5)
    assert all(bulk_validation.band_verdicts(vals).values())
    for k, (lo, hi) in bulk_validation.BANDS.items():
        assert not bulk_validation.band_verdicts(dict(vals, **{k: lo * 0.999}))[k]
        assert not bulk_validation.band_verdicts(dict(vals, **{k: hi * 1.001}))[k]


def test_respa_drift_matches_the_jax_tool(monkeypatch):
    argv = ['--steps', '3000', '--therm', '500', '--seg', '500', '--mid', '2']
    jseries = _Series(7, seed=5)
    with _jax_tool_stand_ins(monkeypatch, jseries):
        ref, _ = _run_main(_jax_tool('respa_drift'), argv, monkeypatch)
    series = _Series(7, seed=5)
    with _port_tool_stand_ins(monkeypatch, series):
        out = respa_drift.run(steps=3000, therm=500, seg=500, mid=2, device='cpu', echo=False)
    assert round(out['window_ps'], 3) == ref['window_ps']
    assert round(out['drift_K_per_ns'], 1) == ref['drift_K_per_ns']
    assert round(out['endpoint_drift_kJmol'], 2) == ref['endpoint_drift_kJmol']
    assert out['nan'] == ref['nan'] is False
    assert {k: v for k, v in out['variant'].items() if k != 'device'} == ref['variant']
    dt = 0.2e-3 * 2 * 2
    ts = np.asarray([500 * k * dt for k in range(1, 7)])
    slope, k_per_ns = respa_drift.drift_fit(ts, series.energies[1:])
    assert abs(slope - np.polyfit(ts, series.energies[1:], 1)[0]) <= 1e-12 * abs(slope)
    assert k_per_ns == out['drift_K_per_ns']
