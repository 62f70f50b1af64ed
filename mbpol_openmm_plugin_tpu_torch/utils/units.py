"""Unit constants (same values as mbpol_openmm_plugin_tpu/utils/units.py).

Internal units are OpenMM's: nm / kJ/mol / amu / e / ps.
"""

NM_TO_ANGSTROM = 10.0
ANGSTROM_TO_NM = 0.1
CAL_TO_JOULE = 4.184          # thermochemical calorie
KCAL_PER_MOL_TO_KJ_PER_MOL = 4.184
KJ_PER_MOL_TO_KCAL_PER_MOL = 1.0 / 4.184

# Coulomb constant in OpenMM internal units: (kJ/mol)*nm/e^2
ELECTRIC = 138.9354558456

# Debye conversion used by the SCF convergence test
DEBYE = 48.033324

# Boltzmann constant, kJ/(mol*K) (CODATA)
BOLTZMANN_KJ_MOL_K = 8.31446261815324e-3
