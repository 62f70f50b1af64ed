"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the program."""
import ast
import os
import subprocess
import sys

from port_bench.harness import bench, spec

RUN_PATH = """
import glob, importlib.util, os, sys
sys.path.insert(0, {root!r})
import port_bench.run, port_bench.control
from port_bench.harness import bench, compare, roofline, spec, sut, trace
from port_bench.reference import electrostatics, mbpol, tables
sut.Run  # the program's modules that a run imports:
from mbpol_openmm_plugin_tpu_torch.md.simulation import Simulation
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol
from mbpol_openmm_plugin_tpu_torch.ops import _build
for path in glob.glob(os.path.join({root!r}, 'port_bench', 'metrics', '*.py')):
    s = importlib.util.spec_from_file_location('m', path)
    s.loader.exec_module(importlib.util.module_from_spec(s))
print(sorted({{k.split('.')[0] for k in sys.modules}}))
"""


def test_run_path_loads_no_jax():
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    out = subprocess.run([sys.executable, '-c', RUN_PATH.format(root=spec.ROOT)],
                         capture_output=True, text=True, env=env, check=True)
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert 'mbpol_openmm_plugin_tpu_torch' in tops
    assert not tops & set(bench.FORBIDDEN), tops & set(bench.FORBIDDEN)


def test_names_are_compared_whole(monkeypatch):
    for name in ('mbpol_openmm_plugin_tpu_torch', 'mbpol_openmm_plugin_tpu_torch.md',
                 'jaxtyping', 'flaxen'):
        monkeypatch.setitem(sys.modules, name, sys)
    assert bench.forbidden_modules() == []
    for name in ('jax', 'jaxlib.xla_client', 'flax', 'mbpol_openmm_plugin_tpu.system'):
        with monkeypatch.context() as m:
            m.setitem(sys.modules, name, sys)
            assert bench.forbidden_modules() == [name.split('.')[0]]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ('.' * node.level) + (node.module or '')


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(spec.BENCH_DIR, 'reference')
    for fname in os.listdir(ref):
        if fname.endswith('.py'):
            for mod in _imports(os.path.join(ref, fname)):
                top = mod.split('.')[0]
                assert mod.startswith('.') or top in ('math', 'functools', 'os', 'numpy',
                                                      'torch'), (fname, mod)
