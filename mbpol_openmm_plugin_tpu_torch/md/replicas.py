"""Replica-batched force evaluation (port of mbpol_openmm_plugin_tpu/md/replicas.py).

The JAX package vmaps the potential over a leading replica axis. Here each
replica is one evaluation, in a loop, stacked: the same bits as a single
evaluation, and on a card inside a captured step about R times one
evaluation's device time.
"""
from __future__ import annotations

import torch

from mbpol_openmm_plugin_tpu_torch.models.potential import MBPol


def replica_energy_forces(potential: MBPol):
    """fn(positions [R, natoms, 3]) -> (E [R], F [R, natoms, 3],
    converged [R]): each replica's SCF converges on its own."""

    def fn(positions):
        es, fs, oks = [], [], []
        for p in potential.as_positions(positions):
            e, f, _, diag = potential._energy_forces_impl(p)
            es.append(e)
            fs.append(f)
            oks.append(diag['converged'] if 'converged' in diag
                       else torch.ones((), dtype=torch.bool, device=p.device))
        return torch.stack(es), torch.stack(fs), torch.stack(oks)

    return fn
