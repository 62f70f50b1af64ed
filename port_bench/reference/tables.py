"""The reference's own copy of the MB-pol constant tables (`data/*.npz`)
and unit constants."""
import functools
import os

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data')

NM_TO_ANGSTROM = 10.0
KCAL_TO_KJ = 4.184
ELECTRIC = 138.9354558456          # Coulomb constant, (kJ/mol) nm / e^2
DEBYE = 48.033324                  # the SCF metric's conversion
BOLTZMANN = 8.31446261815324e-3    # kJ/(mol K)


@functools.lru_cache(maxsize=None)
def load(name):
    """One table as a dict of numpy arrays."""
    with np.load(os.path.join(DATA_DIR, name + '.npz')) as z:
        return {k: z[k] for k in z.files}


def scalars(name):
    """The 0-d entries of a table as floats."""
    return {k: float(v) for k, v in load(name).items() if np.ndim(v) == 0}
