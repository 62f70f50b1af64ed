"""PyTorch/CUDA port of the MB-pol water potential framework.

A second package beside the JAX reference ``mbpol_openmm_plugin_tpu``; the
module names mirror it (``system``, ``models/*``, ``ops/*``, ``md/*``) so
each function has an obvious counterpart. This package imports ``torch``
and never ``jax``.

Slices covered so far: water PME molecular dynamics
(``MBPolConfig.for_dynamics()``) in the dense and the block-sparse
electrostatics modes, with the 2B/3B polynomials in plain PyTorch or, as
``MBPolConfig.pip_impl`` says, in a fused kernel; NVE, NVT and NPT
dynamics, minimization and two- and three-level r-RESPA; and the cluster (NoCutoff)
path: polarizable electrostatics of non-periodic systems under SOR, DIIS or
ASPC, system moments, the potential on a grid, the flat-bottom restraint,
water + Cl- systems without electrostatics and any site layout; and the
large-box pieces: the sparse (water-pair list) electrostatics the CPU
takes above 512 waters, list compaction, the reference's triplet
enumeration, the site-chunked PME grid, the host voxel-hash lists
(``ops/native.py``), capacity plans (``parallel/plan.py``) and
compensated accumulation (``utils/compensated.py``); and device meshes
(``parallel/mesh.py``): one process splitting an evaluation, the beads of
PIMD or the slots of REMD over the devices of a mesh. The
direct-space electrostatics pair work of PME and the fused polynomials run
in hand-written CUDA kernels on CUDA float32 tensors
(``ops/elec_direct.py``, ``ops/elec_direct_bs.py``, ``ops/pip_fused.py``;
sources in ``csrc/``) and in their plain PyTorch twins on the CPU.

Units follow OpenMM: nm, kJ/mol, amu, e, ps.
"""

__version__ = "0.1.0"

import torch as _torch

# MB-pol's PIP fits cancel across ~6 orders of magnitude; reduced-precision
# (TF32) matmul passes cost O(10-100) kcal/mol. This is the torch form of
# the JAX package's process-wide 'highest' matmul precision.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision('highest')

from mbpol_openmm_plugin_tpu_torch.utils import units  # noqa: E402,F401
