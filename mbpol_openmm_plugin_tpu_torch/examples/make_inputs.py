"""Write the example input PDBs (water14 cluster, water256 bulk, water3)
from the geometry fixtures (examples/make_inputs.py, without the JAX
package).

    python -m mbpol_openmm_plugin_tpu_torch.examples.make_inputs [--out DIR]

writes them into DIR (default this package's directory).
"""
from __future__ import annotations

import argparse
import os

from mbpol_openmm_plugin_tpu_torch.examples import _common


def run(directory=None, echo=True):
    """{name: path} of the PDBs written into `directory`."""
    directory = _common.HERE if directory is None else directory
    out = {}
    for name in _common.PDBS:
        out[name] = _common.write_pdb(name, os.path.join(directory, name + '.pdb'))
        if echo:
            print('wrote', out[name])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out', default=None, help='directory (default this package directory)')
    a = ap.parse_args(argv)
    run(a.out)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
