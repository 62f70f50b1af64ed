"""Order-5 cardinal B-splines for PME (port of mbpol_openmm_plugin_tpu/ops/bspline.py).

`bspline5` gives the spline values and derivatives at fractional offsets
(computeBSplinePoint); `bspline_moduli` is the host-side numpy computation
of the squared DFT moduli with the reference's epsilon fix and zeta
correction (initializeBSplineModuli).
"""
import functools

import numpy as np
import torch

ORDER = 5


def bspline5(w):
    """theta [..., 5, 4]: for each of the 5 spline points at fractional
    offset w in [0,1), the value and 1st/2nd/3rd derivative coefficients."""
    A = {}
    A[2, 2] = w
    A[2, 1] = 1.0 - w
    A[3, 3] = 0.5 * w * A[2, 2]
    A[3, 2] = 0.5 * ((1.0 + w) * A[2, 1] + (2.0 - w) * A[2, 2])
    A[3, 1] = 0.5 * (1.0 - w) * A[2, 1]
    for i in range(4, ORDER + 1):
        k = i - 1
        denom = 1.0 / k
        A[i, i] = denom * w * A[k, k]
        for j in range(1, i - 1):
            A[i, i - j] = denom * ((w + j) * A[k, i - j - 1] + (i - j - w) * A[k, i - j])
        A[i, 1] = denom * (1.0 - w) * A[k, 1]

    def diff(row, top):
        """One finite-difference pass: B'_n(x) = B_{n-1}(x) - B_{n-1}(x-1)."""
        out = {top: row[top - 1]}
        for i in range(top - 1, 1, -1):
            out[i] = row[i - 1] - row[i]
        out[1] = -row[1]
        return out

    d1 = diff({j: A[ORDER - 1, j] for j in range(1, ORDER)}, ORDER)
    r3 = {j: A[ORDER - 2, j] for j in range(1, ORDER - 1)}
    d2 = diff(diff(r3, ORDER - 1), ORDER)
    r2 = {j: A[ORDER - 3, j] for j in range(1, ORDER - 2)}
    d3 = diff(diff(diff(r2, ORDER - 2), ORDER - 1), ORDER)

    cols = [torch.stack([A[ORDER, j], d1[j], d2[j], d3[j]], dim=-1)
            for j in range(1, ORDER + 1)]
    return torch.stack(cols, dim=-2)


@functools.lru_cache(maxsize=None)
def bspline_moduli(dims):
    """Squared DFT moduli of the order-5 B-spline along each grid dimension
    (tuple of 3 float64 numpy arrays)."""
    order = ORDER
    array = np.zeros(order)
    x = 0.0
    array[0] = 1.0 - x
    array[1] = x
    for k in range(2, order):
        denom = 1.0 / k
        array[k] = x * array[k - 1] * denom
        for i in range(1, k):
            array[k - i] = ((x + i) * array[k - i - 1] + ((k - i + 1) - x) * array[k - i]) * denom
        array[0] = (1.0 - x) * array[0] * denom

    out = []
    for size in dims:
        bsarray = np.zeros(size + 1)
        for i in range(2, min(order + 2, size + 1)):
            bsarray[i] = array[i - 2]
        modulus = np.zeros(size)
        factor = 2.0 * np.pi / size
        for i in range(size):
            arg = factor * i * (np.arange(1, size + 1) - 1)
            s1 = np.sum(bsarray[1:size + 1] * np.cos(arg))
            s2 = np.sum(bsarray[1:size + 1] * np.sin(arg))
            modulus[i] = s1 * s1 + s2 * s2
        eps = 1.0e-7
        if modulus[0] < eps:
            modulus[0] = 0.5 * modulus[1]
        for i in range(1, size - 1):
            if modulus[i] < eps:
                modulus[i] = 0.5 * (modulus[i - 1] + modulus[i + 1])
        if modulus[size - 1] < eps:
            modulus[size - 1] = 0.5 * modulus[size - 2]
        # zeta correction
        jcut = 50
        for i in range(1, size + 1):
            k = i - 1
            if i > size // 2:
                k = k - size
            if k == 0:
                zeta = 1.0
            else:
                s1 = 1.0
                s2 = 1.0
                factor2 = np.pi * k / size
                for j in range(1, jcut + 1):
                    arg = factor2 / (factor2 + np.pi * j)
                    s1 += arg ** order
                    s2 += arg ** (2 * order)
                for j in range(1, jcut + 1):
                    arg = factor2 / (factor2 - np.pi * j)
                    s1 += arg ** order
                    s2 += arg ** (2 * order)
                zeta = s2 / s1
            modulus[i - 1] *= zeta * zeta
        out.append(modulus)
    return tuple(out)
