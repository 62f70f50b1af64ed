"""Compensated (Kahan-Babuska-Neumaier) accumulation for float32
integration (port of mbpol_openmm_plugin_tpu/utils/compensated.py).

In a long float32 NVE run the position update p += dt * v adds an
increment ~4 orders of magnitude below |p| (0.2 fs x a thermal velocity is
~1e-4 nm against |p| ~ 1 nm), so every step rounds away part of the
increment's low bits. Keeping each integrated quantity as an unevaluated
float32 pair (value + compensation) carries those bits forward: the
Neumaier two-sum gives ~2x float32 precision on the accumulated sum while
every consumer (the force evaluation, PME, the kernels) still reads a plain
float32 tensor. The error term has no multiplication, so no FMA
contraction can break it. tools/nve_drift.py (`--kahan`) uses it.
"""
from __future__ import annotations

import torch


def comp_add(x, c, dx):
    """One compensated accumulation step: (x, c) <- (x + c) + dx.

    x: the running value consumers read; c: the carried low-order
    compensation; dx: the increment. Returns (x', c') with x' + c' equal to
    x + c + dx to ~float32^2 precision (Neumaier: the error is taken from
    whichever operand dominates, so it is exact for either magnitude
    ordering)."""
    y = dx + c
    t = x + y
    c_new = torch.where(torch.abs(x) >= torch.abs(y),
                        (x - t) + y,       # the low bits of y lost in the add
                        (y - t) + x)       # x was the small operand
    return t, c_new


def comp_zero_like(x):
    """A fresh compensation term for an integrated quantity."""
    return torch.zeros_like(x)
