"""The PyTorch port imports without jax and sets the float32 precision
switches at import; its parameter tables are byte-identical copies of the
JAX package's."""
import os
import subprocess
import sys

import pytest

from mbpol_openmm_plugin_tpu_torch import _data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    'mbpol_openmm_plugin_tpu_torch',
    'mbpol_openmm_plugin_tpu_torch.system',
    'mbpol_openmm_plugin_tpu_torch.convert',
    'mbpol_openmm_plugin_tpu_torch.models.one_body',
    'mbpol_openmm_plugin_tpu_torch.models.two_body',
    'mbpol_openmm_plugin_tpu_torch.models.three_body',
    'mbpol_openmm_plugin_tpu_torch.models.dispersion',
    'mbpol_openmm_plugin_tpu_torch.models.electrostatics',
    'mbpol_openmm_plugin_tpu_torch.models.pme',
    'mbpol_openmm_plugin_tpu_torch.models.pme_sparse',
    'mbpol_openmm_plugin_tpu_torch.models.potential',
    'mbpol_openmm_plugin_tpu_torch.models.restraint',
    'mbpol_openmm_plugin_tpu_torch.ops.gather',
    'mbpol_openmm_plugin_tpu_torch.ops.polyeval',
    'mbpol_openmm_plugin_tpu_torch.ops.neighbors',
    'mbpol_openmm_plugin_tpu_torch.ops.gamma',
    'mbpol_openmm_plugin_tpu_torch.ops.bspline',
    'mbpol_openmm_plugin_tpu_torch.ops.elec_direct',
    'mbpol_openmm_plugin_tpu_torch.ops.elec_direct_bs',
    'mbpol_openmm_plugin_tpu_torch.ops.elec_direct_check',
    'mbpol_openmm_plugin_tpu_torch.ops.pip_fused',
    'mbpol_openmm_plugin_tpu_torch.ops.pip_fused_check',
    'mbpol_openmm_plugin_tpu_torch.ops._build',
    'mbpol_openmm_plugin_tpu_torch.ops.native',
    'mbpol_openmm_plugin_tpu_torch.parallel',
    'mbpol_openmm_plugin_tpu_torch.parallel.mesh',
    'mbpol_openmm_plugin_tpu_torch.parallel.plan',
    'mbpol_openmm_plugin_tpu_torch.utils.compensated',
    'mbpol_openmm_plugin_tpu_torch.tools.nve_drift',
    'mbpol_openmm_plugin_tpu_torch.md.integrators',
    'mbpol_openmm_plugin_tpu_torch.md.pressure',
    'mbpol_openmm_plugin_tpu_torch.md.remd',
    'mbpol_openmm_plugin_tpu_torch.md.replicas',
    'mbpol_openmm_plugin_tpu_torch.md.rpmd',
    'mbpol_openmm_plugin_tpu_torch.md.simulation',
    'mbpol_openmm_plugin_tpu_torch.md.step_graph',
    'mbpol_openmm_plugin_tpu_torch.utils.consts',
    'mbpol_openmm_plugin_tpu_torch.tools.step_breakdown',
    'mbpol_openmm_plugin_tpu_torch.app',
    'mbpol_openmm_plugin_tpu_torch.app.units_compat',
    'mbpol_openmm_plugin_tpu_torch.app.pdbfile',
    'mbpol_openmm_plugin_tpu_torch.app.forcefield',
    'mbpol_openmm_plugin_tpu_torch.app.netcdf',
    'mbpol_openmm_plugin_tpu_torch.app.simulation',
    'mbpol_openmm_plugin_tpu_torch.app.builder',
    'mbpol_openmm_plugin_tpu_torch.api',
    'mbpol_openmm_plugin_tpu_torch.analysis',
]

SCRIPT = f"""
import importlib, sys
sys.modules['jax'] = None          # any 'import jax' now raises ImportError
for m in {MODULES!r}:
    importlib.import_module(m)
import torch
assert torch.backends.cuda.matmul.allow_tf32 is False
assert torch.backends.cudnn.allow_tf32 is False
assert torch.get_float32_matmul_precision() == 'highest'
assert not any(k == 'jax' or k.startswith(('jax.', 'mbpol_openmm_plugin_tpu.'))
               or k == 'mbpol_openmm_plugin_tpu' for k in sys.modules if sys.modules[k])
print('ok')
"""


def test_port_imports_without_jax_and_sets_precision():
    out = subprocess.run([sys.executable, '-c', SCRIPT], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith('ok')


def test_chip_smoke_refuses_without_the_package(tmp_path):
    """chip_smoke.py alone (no package beside it) exits non-zero and prints
    no result line."""
    import shutil
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
    env = dict(os.environ, PYTHONPATH='')
    out = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize('name', _data.TABLES)
def test_parameter_tables_are_the_jax_packages_bytes(name):
    """The port reads its own data/ copy, byte for byte the JAX package's."""
    assert os.path.dirname(_data.DATA_DIR) == os.path.join(REPO, 'mbpol_openmm_plugin_tpu_torch')
    with open(os.path.join(_data.DATA_DIR, name + '.npz'), 'rb') as f:
        ours = f.read()
    with open(os.path.join(REPO, 'mbpol_openmm_plugin_tpu', 'data', name + '.npz'), 'rb') as f:
        assert ours == f.read()


XML_FILES = ('mbpol.xml', 'customdispersion.xml',
             'mbpol_no_custom_dispersion_no_charge_redistribution.xml')


@pytest.mark.parametrize('name', XML_FILES)
def test_force_field_files_are_the_jax_packages_bytes(name):
    """The port's app/ reads its own force-field XML copies, byte for byte
    the JAX package's."""
    from mbpol_openmm_plugin_tpu_torch.app.forcefield import mbpol_xml_path
    here = os.path.dirname(mbpol_xml_path())
    assert here == os.path.join(REPO, 'mbpol_openmm_plugin_tpu_torch', 'app')
    with open(os.path.join(here, name), 'rb') as f:
        ours = f.read()
    with open(os.path.join(REPO, 'mbpol_openmm_plugin_tpu', 'app', name), 'rb') as f:
        assert ours == f.read()
