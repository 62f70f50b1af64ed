"""Carry a configured potential's state across from the JAX package.

`from_jax_arrays` takes the JAX MBPol's electrostatics parameters, PME
setup and list capacities as plain numpy arrays and scalars (the caller
extracts them; this module imports nothing of JAX) and returns the port's
MBPol evaluating the same static shapes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from mbpol_openmm_plugin_tpu_torch.models.pme import PmeSetup
from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol, MBPolConfig
from mbpol_openmm_plugin_tpu_torch.system import System


def from_jax_arrays(system: System, config: MBPolConfig, *, thole, polarity, damping,
                    mol_index, atom_type, charges, pme_alpha, pme_grid, pme_cutoff,
                    pme_box, pair_cap=None, trip_cap=None, nlist_k_max=None,
                    nlist_kt=None, disp_pair_cap=None, site_perm=None,
                    tile_pair_capacity=None, device='cuda'):
    """The port's MBPol on `device` with the given electrostatics
    parameters (`thole` [5], per-site `polarity`, `damping`, `mol_index`,
    `atom_type`, `charges`), PME setup (alpha, grid, cutoff, box), list
    capacities (`pair_cap`, `trip_cap`, `nlist_k_max`, `nlist_kt`,
    `disp_pair_cap`) and block-mode layout (`site_perm`, the JAX
    `_block_info['site_perm']`, and `tile_pair_capacity`); None keeps the
    port's own value. The s3/s5 line capacity stays the port's (the JAX
    package keeps whole blocks)."""
    pot = MBPol(system, config, device=device)
    if pot.elec_params is not None:
        n = system.n_atoms
        arrays = dict(thole=np.asarray(thole, np.float64),
                      polarity=np.asarray(polarity, np.float64),
                      damping=np.asarray(damping, np.float64),
                      mol_index=np.asarray(mol_index),
                      atom_type=np.asarray(atom_type),
                      charges=np.asarray(charges, np.float64))
        for name, a in arrays.items():
            want = (5,) if name == 'thole' else (n,)
            if a.shape != want:
                raise ValueError(f'{name} must have shape {want}, got {a.shape}')
        pot.elec_params = dataclasses.replace(pot.elec_params, **arrays)
        pot.pme = PmeSetup(alpha=float(pme_alpha), grid=tuple(int(g) for g in pme_grid),
                           cutoff=float(pme_cutoff), box=tuple(float(b) for b in pme_box))
    if pot.use_neighbor_lists:
        for name, val in (('pair_cap', pair_cap), ('trip_cap', trip_cap),
                          ('nlist_k_max', nlist_k_max), ('nlist_kt', nlist_kt)):
            if val is not None:
                setattr(pot, name, int(val))
    if disp_pair_cap is not None and pot.disp_mode == 'pairs':
        pot.disp_pair_cap = int(disp_pair_cap)
    if pot.elec_mode == 'block' and (site_perm is not None or tile_pair_capacity is not None):
        info = pot._block_info
        pot._set_block_perm(info['site_perm'] if site_perm is None else site_perm,
                            info['tile_pair_capacity'] if tile_pair_capacity is None
                            else tile_pair_capacity, info['line_capacity'])
    return pot

