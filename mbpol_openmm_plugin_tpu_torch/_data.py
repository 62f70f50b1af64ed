"""Path-based loader for the MB-pol parameter tables.

The tables live in the JAX package's ``data/`` directory. They are read
straight from the file paths with numpy: importing
``mbpol_openmm_plugin_tpu.data`` would run that package's ``__init__``,
which imports jax.
"""
import functools
import os

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        'mbpol_openmm_plugin_tpu', 'data')


@functools.lru_cache(maxsize=None)
def load(name):
    """Load one archive ('onebody', 'twobody_constants', 'threebody_constants',
    'dms', 'forcefield', 'poly2b_quad', 'poly3b_quad') as a dict of numpy
    arrays/scalars."""
    with np.load(os.path.join(DATA_DIR, name + '.npz')) as z:
        return {k: z[k] for k in z.files}
