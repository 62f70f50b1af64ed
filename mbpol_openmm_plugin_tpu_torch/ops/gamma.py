"""Regularized upper incomplete gamma Q(3/4, x) with fixed iteration counts
(port of mbpol_openmm_plugin_tpu/ops/gamma.py): a fixed-depth series for
x < 1.75 and a Lentz continued fraction above, branch-free.
"""
import torch

_A = 0.75
_LGAMMA_A = 0.20328095143129538  # ln Gamma(3/4)
_SERIES_TERMS = 24
_CF_TERMS = 32


def _series_p(x):
    """P(a,x) = x^a e^-x / Gamma(a) * sum x^n / (a)_{n+1}."""
    xs = torch.where(x > 0, x, 1.0)
    ap = _A
    term = torch.full_like(xs, 1.0 / _A)
    total = term
    for _ in range(_SERIES_TERMS):
        ap = ap + 1.0
        term = term * xs / ap
        total = total + term
    p = total * torch.exp(-xs + _A * torch.log(xs) - _LGAMMA_A)
    return torch.where(x > 0, p, 0.0)


def _cf_q(x):
    """Q(a,x) by Lentz continued fraction (fixed depth)."""
    xs = torch.where(x > 0, x, 1.0)
    tiny = 1e-30
    b = xs + 1.0 - _A
    c = torch.full_like(xs, 1.0 / tiny)
    d = 1.0 / b
    h = d
    for i in range(1, _CF_TERMS + 1):
        an = -i * (i - _A)
        b = b + 2.0
        d = an * d + b
        d = torch.where(torch.abs(d) < tiny, tiny, d)
        c = b + an / c
        c = torch.where(torch.abs(c) < tiny, tiny, c)
        d = 1.0 / d
        h = h * d * c
    q = torch.exp(-xs + _A * torch.log(xs) - _LGAMMA_A) * h
    return torch.where(x > 0, q, 1.0)


def gammq34(x):
    """Q(3/4, x) for x >= 0."""
    small = x < (_A + 1.0)
    return torch.where(small, 1.0 - _series_p(torch.where(small, x, 0.5)),
                       _cf_q(torch.where(small, 2.0, x)))
