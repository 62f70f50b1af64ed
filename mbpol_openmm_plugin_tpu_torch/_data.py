"""Path-based loader for the MB-pol parameter tables.

The port keeps its own copy of the tables it reads in ``data/`` (the
same bytes as the JAX package's ``data/`` files of the same names,
checked by tests/test_torch_import.py). They are read with numpy.
"""
import functools
import os

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data')

TABLES = ('onebody', 'twobody_constants', 'threebody_constants', 'dms', 'forcefield',
          'poly2b_quad', 'poly3b_quad')


@functools.lru_cache(maxsize=None)
def load(name):
    """Load one archive (one of TABLES) as a dict of numpy arrays/scalars."""
    with np.load(os.path.join(DATA_DIR, name + '.npz')) as z:
        return {k: z[k] for k in z.files}
