"""The port's builder (python -m mbpol_openmm_plugin_tpu_torch.app.builder):
each example INI renders to the JAX builder's script with the package name
swapped, `--platform CPU` adds only the platform, and rendered scripts run
end to end on the CPU: examples/mbpol_config.ini (outputs, the NetCDF
variables; no jax in the process), and mbpol_cluster_energy.ini rendered
by both builders and run, the printed energy and the NetCDF forces within
1e-8. The default render (the card) raises without one.
"""
import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import fixtures
from mbpol_openmm_plugin_tpu.app import builder as jbuilder
from mbpol_openmm_plugin_tpu.app import pdbfile as jpdbfile
from mbpol_openmm_plugin_tpu_torch.app import builder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INIS = ([os.path.join(REPO, 'examples', 'mbpol_config.ini')]
        + sorted(glob.glob(os.path.join(REPO, 'examples', 'example_ini', '*.ini'))))
CPU_ARG = ', platform=app.Platform.getPlatformByName("CPU")'
NO_JAX = "import runpy, sys; sys.modules['jax'] = None; "


def _write_water14(directory):
    """water14_cluster.pdb from its fixture (the JAX writer: the same bytes
    as the port's, tests/test_torch_app.py)."""
    d = fixtures.load('water14_cluster')
    atoms = [jpdbfile.Atom(i, str(n), str(rn), int(ri)) for i, (n, rn, ri) in
             enumerate(zip(d['names'], d['resnames'], d['resids']))]
    with open(os.path.join(directory, 'water14_cluster.pdb'), 'w') as fh:
        jpdbfile.write_pdb_frame(fh, jpdbfile.Topology(atoms), d['positions'])


def _env(**kw):
    return dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS='cpu', **kw)


def test_every_example_ini_is_listed():
    assert len(INIS) == 14


@pytest.mark.parametrize('ini', INIS, ids=os.path.basename)
def test_render_is_the_jax_render_with_the_package_swapped(ini):
    ours = builder.render(ini)
    ref = jbuilder.render(ini)
    assert 'mbpol_openmm_plugin_tpu_torch' not in ref
    assert ours == ref.replace('mbpol_openmm_plugin_tpu', 'mbpol_openmm_plugin_tpu_torch')
    assert not re.search(r'mbpol_openmm_plugin_tpu(?!_torch)', ours)
    # --platform CPU: the platform in the app.Simulation line, and the
    # device of a potential the script rebuilds, nothing else
    cpu = builder.render(ini, platform='CPU')
    assert cpu.count(CPU_ARG) == 1
    assert ('simulation = app.Simulation(pdb.topology, system, integrator%s)\n' % CPU_ARG) in cpu
    assert cpu.replace(CPU_ARG, '').replace(', device=pot.device', '') == ours
    compile(cpu, ini, 'exec')
    with pytest.raises(ValueError, match='unknown platform'):
        builder.render(ini, platform='OpenCL')


def test_mbpol_config_end_to_end_on_the_cpu(tmp_path):
    """Render with `python -m ... --platform CPU` and run the script, both in
    processes where `import jax` fails: the log, the trajectory and the
    AMBER NetCDF file with coordinates, velocities and forces."""
    _write_water14(tmp_path)
    ini = os.path.join(REPO, 'examples', 'mbpol_config.ini')
    r = subprocess.run(
        [sys.executable, '-c', NO_JAX + "sys.argv = ['builder', %r, 'run.py', '--platform', "
         "'CPU']; runpy.run_module('mbpol_openmm_plugin_tpu_torch.app.builder', "
         "run_name='__main__')" % ini], cwd=tmp_path, capture_output=True, text=True,
        env=_env(), timeout=120)
    assert r.returncode == 0, r.stderr
    assert CPU_ARG in (tmp_path / 'run.py').read_text()
    r = subprocess.run([sys.executable, '-c', NO_JAX + "runpy.run_path('run.py')"],
                       cwd=tmp_path, capture_output=True, text=True, env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    log = (tmp_path / 'water14_cluster.log').read_text().splitlines()
    assert log[0].startswith('#"Progress (%)","Step","Potential Energy (kJ/mole)"')
    assert [int(line.split(',')[1]) for line in log[1:]] == [2, 3, 4]
    assert all(np.isfinite(float(v)) for line in log[1:] for v in line.split(',')[2:6])
    assert (tmp_path / 'water14_cluster_trajectory.pdb').read_text().count('MODEL') == 3
    from scipy.io import netcdf_file
    nc = netcdf_file(str(tmp_path / 'water14_cluster.nc'), 'r', mmap=False)
    assert nc.Conventions == b'AMBER'
    assert set(nc.variables) >= {'coordinates', 'velocities', 'forces'}
    assert nc.variables['forces'].shape == (3, 56, 3)
    assert np.all(np.isfinite(nc.variables['forces'][:]))
    nc.close()


def test_cluster_energy_both_builders(tmp_path):
    """mbpol_cluster_energy.ini rendered by the JAX builder and by the port's
    (--platform CPU) and run side by side (JAX in float64): the printed
    energy and the NetCDF forces within 1e-8. The port's default render
    raises without a card."""
    ini = os.path.join(REPO, 'examples', 'example_ini', 'mbpol_cluster_energy.ini')
    runs = {}
    for name, render, env in (('jax', jbuilder.render(ini), _env(JAX_ENABLE_X64='1')),
                              ('port', builder.render(ini, platform='CPU'), _env())):
        d = tmp_path / name
        d.mkdir()
        _write_water14(d)
        (d / 'run.py').write_text(render)
        runs[name] = (d, subprocess.Popen([sys.executable, 'run.py'], cwd=d, env=env,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True))
    out = {}
    for name, (d, proc) in runs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-3000:]
        e = float(re.search(r'Potential energy: (\S+) kcal/mol', stdout).group(1))
        from scipy.io import netcdf_file
        nc = netcdf_file(str(d / 'cluster_energy.nc'), 'r', mmap=False)
        f = np.array(nc.variables['forces'][0], np.float64)
        nc.close()
        out[name] = (e, f)
    (e, f), (e_ref, f_ref) = out['port'], out['jax']
    assert abs(e - (-59.2)) < 1.0, e
    assert abs(e - e_ref) <= 1e-8 * abs(e_ref), (e, e_ref)
    # the NetCDF forces are float32 (AMBER): equal unless the values straddle
    # a float32 rounding boundary
    np.testing.assert_allclose(f, f_ref, rtol=1e-8, atol=1e-8 * np.max(np.abs(f_ref))
                               + np.max(np.abs(np.spacing(f_ref.astype(np.float32)))))

    if not torch.cuda.is_available():
        (tmp_path / 'card.py').write_text(builder.render(ini))
        _write_water14(tmp_path)
        r = subprocess.run([sys.executable, 'card.py'], cwd=tmp_path, capture_output=True,
                           text=True, env=_env(), timeout=120)
        assert r.returncode != 0 and 'no CUDA device' in r.stderr, r.stderr[-2000:]
