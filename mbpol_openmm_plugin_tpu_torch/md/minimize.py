"""L-BFGS energy minimization (port of mbpol_openmm_plugin_tpu/md/minimize.py).

The same algorithm as the JAX package's `lbfgs_minimize` (OpenMM's
LocalEnergyMinimizer role): a history of the last `history` (s, y) pairs
in a ring buffer, the two-loop recursion, an Armijo backtracking line
search whose first trial moves no coordinate by more than 0.02 nm, and an
RMS-gradient tolerance. Here it is a Python loop that reads the energies
on the host at every trial; a minimization is not on the MD hot path.
"""
from __future__ import annotations

import torch


def lbfgs_minimize(energy_grad_fn, x0, max_iterations=200, tolerance=10.0, history=8,
                   max_backtracks=20):
    """Minimize a scalar function of an [N, D] tensor.

    energy_grad_fn: x -> (energy, gradient) (the gradient, not the force).
    Converged when the RMS gradient per row (sqrt(|g|^2 / N); kJ/mol/nm for
    positions) is below `tolerance`. Returns (x, energy, dict(iterations,
    grad_rms, converged, energies: the energy at x0 and after each
    accepted step, host floats)).
    """
    shape = x0.shape
    n_rows = x0.numel() // shape[-1]
    m = history

    def eg(xf):
        e, g = energy_grad_fn(xf.reshape(shape))
        return e, g.reshape(-1)

    def grad_rms(g):
        return float(torch.sqrt(torch.sum(g * g) / n_rows))

    def two_loop(g, S, Y, rho, k):
        """The two-loop recursion over the last min(k, m) pairs; slot
        (k - 1) % m is the newest."""
        q = g
        alphas = []
        for i in range(min(k, m)):                   # newest -> oldest
            idx = (k - 1 - i) % m
            a = rho[idx] * torch.dot(S[idx], q)
            q = q - a * Y[idx]
            alphas.append((idx, a))
        gamma = 1.0
        if k > 0:
            newest = (k - 1) % m
            yy = torch.dot(Y[newest], Y[newest])
            if float(yy) > 0:
                gamma = torch.dot(S[newest], Y[newest]) / torch.clamp(yy, min=1e-30)
        r = gamma * q
        for idx, a in reversed(alphas):              # oldest -> newest
            b = rho[idx] * torch.dot(Y[idx], r)
            r = r + (a - b) * S[idx]
        return r

    def line_search(xf, e0, g, d):
        """Backtracking Armijo search along the descent direction d:
        (step, accepted)."""
        g_d = float(torch.dot(g, d))
        t = min(1.0, 0.02 / (float(torch.max(torch.abs(d))) + 1e-30))
        for _ in range(max_backtracks):
            e_t, _ = eg(xf + t * d)
            if float(e_t) <= float(e0) + 1e-4 * t * g_d:
                return t, True
            t = 0.5 * t
        return 0.0, False

    xf = x0.reshape(-1)
    e, g = eg(xf)
    S = torch.zeros((m, xf.numel()), dtype=xf.dtype, device=xf.device)
    Y = torch.zeros_like(S)
    rho = torch.zeros((m,), dtype=xf.dtype, device=xf.device)
    energies = [float(e)]
    k = 0
    it = 0
    while it < max_iterations:
        d = -two_loop(g, S, Y, rho, k)
        if not float(torch.dot(g, d)) < 0:           # not a descent direction
            d = -g
        t, ok = line_search(xf, e, g, d)
        it += 1
        if not ok:                                   # the search failed: stop where we are
            break
        x_new = xf + t * d
        e_new, g_new = eg(x_new)
        s, y = x_new - xf, g_new - g
        ys = torch.dot(y, s)
        if float(ys) > 1e-10:
            slot = k % m
            S[slot], Y[slot], rho[slot] = s, y, 1.0 / torch.clamp(ys, min=1e-30)
            k += 1
        xf, e, g = x_new, e_new, g_new
        energies.append(float(e))
        if grad_rms(g) < tolerance:
            break
    rms = grad_rms(g)
    return xf.reshape(shape), e, dict(iterations=it, grad_rms=rms, converged=rms < tolerance,
                                      energies=energies)
