"""Polarizable PME electrostatics of MB-pol water, plain PyTorch.

TTM4-F charges from the Partridge-Schwenke dipole-moment surface (with
their Jacobian), Thole damping of orders 1/3/5/7, Ewald direct space over
the 4 x 4 site blocks of each water pair under the cutoff (and the
same-water block), the order-5 B-spline PME reciprocal space, the induced
dipoles by SOR iteration to a tight tolerance, and the explicit forces
(direct, reciprocal, induced, and the charges' geometry dependence).
OpenMM's PME parameters: alpha = sqrt(-ln(2 tol)) / cutoff, grid =
ceil(2 alpha L / (3 tol^(1/5))).
"""
import math

import numpy as np
import torch

from .tables import DEBYE, ELECTRIC, NM_TO_ANGSTROM, load

ORDER = 5
SOR = 0.55
GAMMA_3_4 = 1.2254167024651776451290983034
SQRT_PI = math.sqrt(math.pi)
SPREAD_CHUNK = 1 << 25          # elements of a spread / read-back temporary
TCC, TCD, TDD, TDDOH, TDDHH = 0, 1, 2, 3, 4


def pme_parameters(box, cutoff, tol):
    alpha = math.sqrt(-math.log(2.0 * tol)) / cutoff
    grid = tuple(int(math.ceil(2.0 * alpha * float(b) / (3.0 * tol ** 0.2))) for b in box)
    return alpha, grid


# ---------------------------------------------------------------- damping

def gammq34(x):
    """Regularized upper incomplete gamma Q(3/4, x), x >= 0."""
    a, lg = 0.75, 0.20328095143129538
    small = x < a + 1.0
    xs = torch.where(small & (x > 0), x, torch.ones_like(x))
    ap, term = a, torch.full_like(xs, 1.0 / a)
    total = term
    for _ in range(24):
        ap += 1.0
        term = term * xs / ap
        total = total + term
    p = torch.where(x > 0, total * torch.exp(-xs + a * torch.log(xs) - lg), 0.0)
    xl = torch.where(small, torch.full_like(x, 2.0), x)
    tiny = 1e-30
    b = xl + 1.0 - a
    c = torch.full_like(xl, 1.0 / tiny)
    d = 1.0 / b
    h = d
    for i in range(1, 33):
        an = -i * (i - a)
        b = b + 2.0
        d = an * d + b
        d = torch.where(torch.abs(d) < tiny, tiny, d)
        c = b + an / c
        c = torch.where(torch.abs(c) < tiny, tiny, c)
        d = 1.0 / d
        h = h * d * c
    q = torch.exp(-xl + a * torch.log(xl) - lg) * h
    return torch.where(small, 1.0 - p, q)


def thole(u, gamma, orders):
    """{order: scale} of the MB-pol Thole damping at u = r / (A_i A_j)^(1/6)."""
    ratio = u ** 4
    ex = torch.exp(-gamma * ratio)
    s3 = 1.0 - ex
    s5 = s3 - (4.0 / 3.0) * gamma * ex * ratio
    out = {3: s3, 5: s5}
    if 1 in orders:
        out[1] = s3 + gamma ** 0.25 * u * GAMMA_3_4 * gammq34(gamma * ratio)
    if 7 in orders:
        out[7] = s5 - (4.0 / 15.0) * gamma * (4.0 * gamma * ratio - 1.0) * ex * ratio
    return out


def ewald_bn(alpha, r, inv_r):
    """Ewald real-space factors bn0 .. bn3."""
    ra = alpha * r
    bn = [torch.special.erfc(ra) * inv_r]
    alsq2, alsq2n = 2.0 * alpha * alpha, 1.0 / (SQRT_PI * alpha)
    ex = torch.exp(-(ra * ra))
    inv_r2 = inv_r * inv_r
    for k in range(1, 4):
        alsq2n *= alsq2
        bn.append((float(2 * k - 1) * bn[-1] + alsq2n * ex) * inv_r2)
    return bn


# ---------------------------------------------------------------- charges

_GAMMA_M = 0.426706882
_DMS = dict(costhe=-0.24780227221366464506, reoh=0.958649, b1D=1.0, a=0.2999, b=-0.6932,
            c0=1.0099, c1=-0.1801, c2=0.0892, bohr_a=0.52917721092)


def _powers(x, n=15):
    cols = [torch.ones_like(x)]
    for _ in range(n - 1):
        cols.append(cols[-1] * x)
    return torch.stack(cols, dim=-1)


def water_charges(w):
    """(qH1, qH2, qM) [n, 3] of waters w [n, 3, 3] (O, H1, H2; nm)."""
    k, d = _DMS, load('dms')
    i0, i1, i2 = (torch.as_tensor(d[n][1:] - 1, device=w.device)
                  for n in ('idxD0', 'idxD1', 'idxD2'))
    coef = torch.as_tensor(d['coefD'][1:], dtype=w.dtype, device=w.device)
    coef0 = float(d['coefD'][0])
    o, h1, h2 = w[:, 0], w[:, 1], w[:, 2]
    r1, r2 = (h1 - o) * NM_TO_ANGSTROM, (h2 - o) * NM_TO_ANGSTROM
    d1 = torch.sqrt(torch.sum(r1 * r1, dim=-1))
    d2 = torch.sqrt(torch.sum(r2 * r2, dim=-1))
    costh = torch.sum(r1 * r2, dim=-1) / (d1 * d2)
    efac = torch.exp(-k['b1D'] * ((d1 - k['reoh']) ** 2 + (d2 - k['reoh']) ** 2))
    v1 = _powers((d1 - k['reoh']) / k['reoh'])
    v2 = _powers((d2 - k['reoh']) / k['reoh'])
    v3 = _powers(costh - k['costhe'])
    p1 = torch.sum(coef * v1[:, i0] * v2[:, i1] * v3[:, i2], dim=-1)
    p2 = torch.sum(coef * v1[:, i1] * v2[:, i0] * v3[:, i2], dim=-1)
    pl2 = 0.5 * (3.0 * costh * costh - 1.0)
    pc0 = k['a'] * (d1 ** k['b'] + d2 ** k['b']) * (k['c0'] + costh * k['c1'] + pl2 * k['c2'])
    q1 = coef0 + p1 * efac + pc0 * k['bohr_a']
    q2 = coef0 + p2 * efac + pc0 * k['bohr_a']
    g1 = 1.0 - _GAMMA_M
    g2div1 = (_GAMMA_M / 2.0) / g1
    return torch.stack([q1 + g2div1 * (q1 + q2), q2 + g2div1 * (q1 + q2), -(q1 + q2) / g1],
                       dim=-1)


def water_charge_jacobian(w):
    """dq/dr [n, 3 (atom), 3 (charge H1, H2, M), 3 (xyz)], forward mode."""
    tangents = torch.eye(9, dtype=w.dtype, device=w.device).reshape(9, 1, 3, 3)

    def column(t):
        return torch.func.jvp(water_charges, (w,), (t.expand_as(w),))[1]

    dq = torch.func.vmap(column)(tangents)                 # [9, n, 3q]
    return dq.reshape(3, 3, -1, 3).permute(2, 0, 3, 1)


# ---------------------------------------------------------------- reciprocal

def bspline5(w):
    """[..., 5, 3]: value, first and second derivative of the 5 spline
    weights at fractional offsets w."""
    A = {(2, 2): w, (2, 1): 1.0 - w}
    A[3, 3] = 0.5 * w * A[2, 2]
    A[3, 2] = 0.5 * ((1.0 + w) * A[2, 1] + (2.0 - w) * A[2, 2])
    A[3, 1] = 0.5 * (1.0 - w) * A[2, 1]
    for i in range(4, ORDER + 1):
        k = i - 1
        A[i, i] = w * A[k, k] / k
        for j in range(1, i - 1):
            A[i, i - j] = ((w + j) * A[k, i - j - 1] + (i - j - w) * A[k, i - j]) / k
        A[i, 1] = (1.0 - w) * A[k, 1] / k

    def diff(row, top):
        out = {top: row[top - 1]}
        for i in range(top - 1, 1, -1):
            out[i] = row[i - 1] - row[i]
        out[1] = -row[1]
        return out

    d1 = diff({j: A[ORDER - 1, j] for j in range(1, ORDER)}, ORDER)
    d2 = diff(diff({j: A[ORDER - 2, j] for j in range(1, ORDER - 1)}, ORDER - 1), ORDER)
    return torch.stack([torch.stack([A[ORDER, j], d1[j], d2[j]], dim=-1)
                        for j in range(1, ORDER + 1)], dim=-2)


def bspline_moduli(size):
    """Squared DFT moduli of the order-5 B-spline on `size` points, with
    the small-modulus fix and the zeta correction."""
    arr = np.zeros(ORDER)
    arr[0] = 1.0
    for k in range(2, ORDER):
        arr[k] = 0.0
        for i in range(1, k):
            arr[k - i] = (i * arr[k - i - 1] + (k - i + 1) * arr[k - i]) / k
        arr[0] = arr[0] / k
    bs = np.zeros(size + 1)
    for i in range(2, min(ORDER + 2, size + 1)):
        bs[i] = arr[i - 2]
    mod = np.zeros(size)
    for i in range(size):
        arg = 2.0 * np.pi / size * i * np.arange(size)
        mod[i] = np.sum(bs[1:] * np.cos(arg)) ** 2 + np.sum(bs[1:] * np.sin(arg)) ** 2
    if mod[0] < 1e-7:
        mod[0] = 0.5 * mod[1]
    for i in range(1, size - 1):
        if mod[i] < 1e-7:
            mod[i] = 0.5 * (mod[i - 1] + mod[i + 1])
    if mod[size - 1] < 1e-7:
        mod[size - 1] = 0.5 * mod[size - 2]
    for i in range(1, size + 1):
        k = i - 1 if i <= size // 2 else i - 1 - size
        if k == 0:
            continue
        f = np.pi * k / size
        s1 = s2 = 1.0
        for j in range(1, 51):
            for a in (f / (f + np.pi * j), f / (f - np.pi * j)):
                s1 += a ** ORDER
                s2 += a ** (2 * ORDER)
        mod[i - 1] *= (s2 / s1) ** 2
    return mod


class Grid:
    """Spline matrices of the sites and the reciprocal convolution of one
    box: phi10 (potential, gradient, Hessian) at the sites of a source."""

    COMP = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (2, 0, 0),
            (0, 2, 0), (0, 0, 2), (1, 1, 0), (1, 0, 1), (0, 1, 1)]
    HESS = [[4, 7, 8], [7, 5, 9], [8, 9, 6]]

    def __init__(self, sites, box, alpha, grid):
        dt, dev = sites.dtype, sites.device
        self.grid = grid
        dims = torch.as_tensor(grid, dtype=dt, device=dev)
        dims_i = torch.as_tensor(grid, device=dev)
        pos = sites - torch.floor(sites / box + 0.5) * box
        fr = dims * (pos / box + 0.5)
        ifr = torch.floor(fr)
        theta = bspline5(fr - ifr)                                    # [N, 3, 5, 3]
        start = torch.remainder(ifr.to(torch.int64) - (ORDER - 1), dims_i)
        off = torch.arange(ORDER, device=dev)
        self.S = []
        for ax, nax in enumerate(grid):
            lines = torch.remainder(start[:, ax:ax + 1] + off[None], nax)
            onehot = (lines[:, :, None] == torch.arange(nax, device=dev)).to(dt)
            self.S.append(torch.einsum('nkg,nkd->ngd', onehot, theta[:, ax]))
        mods = [bspline_moduli(g) for g in grid]
        mv = [np.where(np.arange(g) < (g + 1) // 2, np.arange(g), np.arange(g) - g) for g in grid]
        b = box.detach().cpu().double().numpy()
        m2 = ((mv[0] / b[0])[:, None, None] ** 2 + (mv[1] / b[1])[None, :, None] ** 2
              + (mv[2] / b[2])[None, None, :] ** 2)
        binv = 1.0 / (mods[0][:, None, None] * mods[1][None, :, None] * mods[2][None, None, :])
        m2s = np.where(m2 > 0, m2, 1.0)
        et = np.where(m2 > 0, np.exp(-np.pi ** 2 / alpha ** 2 * m2s) / m2s * binv, 0.0)
        et = et / (np.pi * b[0] * b[1] * b[2])
        self.eterm = torch.as_tensor(et, dtype=dt, device=dev)
        self.pscale = dims / box

    def _spread(self, wx, sy, sz):
        nx, ny, nz = self.grid
        n = wx.shape[0]
        c = max(min(n, SPREAD_CHUNK // (ny * nz)), 1)
        g = None
        for r0 in range(0, n, c):
            a = torch.einsum('nh,nk->nhk', sy[r0:r0 + c], sz[r0:r0 + c]).reshape(-1, ny * nz)
            part = wx[r0:r0 + c].T @ a
            g = part if g is None else g + part
        return g.reshape(nx, ny, nz)

    def _convolve(self, g):
        return torch.real(torch.fft.ifftn(torch.fft.fftn(g) * self.eterm) * g.numel())

    def _readback(self, g):
        Sx, Sy, Sz = self.S
        nx, ny, nz = g.shape
        gz = g.reshape(nx * ny, nz).T
        n = Sx.shape[0]
        c = max(min(n, SPREAD_CHUNK // (3 * nx * ny)), 1)
        pairs = sorted({(b, cc) for _, b, cc in self.COMP})
        out = []
        for r0 in range(0, n, c):
            sx, sy, sz = Sx[r0:r0 + c], Sy[r0:r0 + c], Sz[r0:r0 + c]
            m = sx.shape[0]
            t1 = [(sz[:, :, k] @ gz).reshape(m, nx, ny) for k in range(3)]
            t2 = {(b, k): torch.sum(t1[k] * sy[:, None, :, b], dim=-1) for b, k in pairs}
            out.append(torch.stack([torch.sum(t2[(b, k)] * sx[:, :, a], dim=-1)
                                    for a, b, k in self.COMP], dim=-1))
        return torch.cat(out)

    def charge_phi(self, q):
        Sx, Sy, Sz = self.S
        return self._readback(self._convolve(self._spread(q[:, None] * Sx[..., 0], Sy[..., 0],
                                                          Sz[..., 0])))

    def dipole_phi(self, mu):
        Sx, Sy, Sz = self.S
        smu = mu * self.pscale[None, :]
        wx = torch.cat([smu[:, 0:1] * Sx[..., 1], smu[:, 1:2] * Sx[..., 0],
                        smu[:, 2:3] * Sx[..., 0]])
        sy = torch.cat([Sy[..., 0], Sy[..., 1], Sy[..., 0]])
        sz = torch.cat([Sz[..., 0], Sz[..., 0], Sz[..., 1]])
        return self._readback(self._convolve(self._spread(wx, sy, sz)))


# ---------------------------------------------------------------- energy

def pme_energy_forces(sites, box, pairs, cutoff, tol, scf_epsilon, scf_max_iterations):
    """(energy kJ/mol, forces [n, 4, 3] on every site, (SCF iterations,
    epsilon)) of waters sites [n, 4, 3] (M placed, molecules whole) in the
    box [3]; pairs [P, 2]: every water pair (i < j) whose sites may lie
    within the cutoff."""
    dt, dev = sites.dtype, sites.device
    n = sites.shape[0]
    ff = load('forcefield')
    per = np.stack([ff['atom_O'], ff['atom_H'], ff['atom_H'], ff['atom_M']])   # q, damp, pol
    th = np.asarray(ff['thole'], np.float64)
    d16 = per[:, 1] ** (1.0 / 6.0)
    inv_damp = torch.as_tensor(1.0 / (d16[:, None] * d16[None, :]), dtype=dt, device=dev)
    is_o = np.array([True, False, False, False])
    g_in = torch.as_tensor(np.where(is_o[:, None] | is_o[None, :], th[TDDOH], th[TDDHH]),
                           dtype=dt, device=dev)
    pol = torch.as_tensor(np.tile(per[:, 2], n), dtype=dt, device=dev)
    alpha, grid = pme_parameters(box.tolist(), cutoff, tol)

    q_w = water_charges(sites[:, :3])
    dq_w = water_charge_jacobian(sites[:, :3])
    q4 = torch.cat([torch.zeros_like(q_w[:, :1]), q_w], dim=1)
    q = q4.reshape(-1)
    ia, ib = pairs[:, 0], pairs[:, 1]

    def to_waters(va, vb):
        out = torch.zeros((n,) + va.shape[1:], dtype=dt, device=dev)
        return out.index_add(0, ia, va).index_add(0, ib, vb)

    # inter-water 4 x 4 blocks
    delta = sites[ib][:, None] - sites[ia][:, :, None]
    delta = delta - torch.floor(delta / box + 0.5) * box                   # r_b - r_a
    r2 = torch.sum(delta * delta, dim=-1)
    within = r2 <= cutoff * cutoff
    r = torch.sqrt(torch.where(within, r2, 1.0))
    inv_r = torch.where(within, 1.0 / r, 0.0)
    rr1, rr3, rr5, rr7 = inv_r, inv_r ** 3, 3.0 * inv_r ** 5, 15.0 * inv_r ** 7
    bn = [torch.where(within, b, 0.0) for b in ewald_bn(alpha, r, inv_r)]
    u = r * inv_damp
    s_cc = thole(u, float(th[TCC]), (1, 3))
    s_cd = thole(u, float(th[TCD]), (3, 5))
    s_dd = thole(u, float(th[TDD]), (3, 5, 7))
    qa, qb = q4[ia], q4[ib]

    def w_(x):
        return torch.where(within, x, 0.0)

    kdir = w_(bn[1] - (1.0 - s_cc[3]) * rr3)
    pf1 = w_((1.0 - s_dd[3]) * rr3 - bn[1])
    pf2 = w_(bn[2] - (1.0 - s_dd[5]) * rr5)
    k1 = w_(bn[0] - rr1 * (1.0 - s_cc[1]))
    w3 = w_(bn[1] - rr3 * (1.0 - s_cd[3]))
    w5 = w_(bn[2] - rr5 * (1.0 - s_dd[5]))

    # same-water block
    din = sites[:, None, :, :] - sites[:, :, None, :]
    off = ~torch.eye(4, dtype=torch.bool, device=dev)
    rin = torch.sqrt(torch.where(off, torch.sum(din * din, dim=-1), 1.0))
    inv_in = torch.where(off, 1.0 / rin, 0.0)
    rr3i, rr5i, rr7i = inv_in ** 3, 3.0 * inv_in ** 5, 15.0 * inv_in ** 7
    bni = [torch.where(off, b, 0.0) for b in ewald_bn(alpha, rin, inv_in)]
    sdi = thole(rin * inv_damp, g_in, (3, 5, 7))

    # fixed field
    grid_ = Grid(sites.reshape(-1, 3), box, alpha, grid)
    pscale = grid_.pscale
    phi = grid_.charge_phi(q)
    efield = (-pscale[None, :] * phi[:, 1:4]).reshape(n, 4, 3)
    efield = efield + to_waters(-torch.einsum('pab,pb,pabd->pad', kdir, qb, delta),
                                torch.einsum('pab,pa,pabd->pbd', kdir, qa, delta))
    efield = efield - torch.einsum('mab,mb,mabd->mad', bni[1] - rr3i, q4, din)

    pf1i = (1.0 - sdi[3]) * rr3i - bni[1]
    pf2i = bni[2] - (1.0 - sdi[5]) * rr5i
    self_term = (4.0 / 3.0) * alpha ** 3 / SQRT_PI

    def field(mu):
        m4 = mu.reshape(n, 4, 3)
        mua, mub = m4[ia], m4[ib]
        dotb = torch.einsum('pbd,pabd->pab', mub, delta)
        dota = torch.einsum('pad,pabd->pab', mua, delta)
        fa = torch.einsum('pab,pabd->pad', pf2 * dotb, delta) + torch.einsum('pab,pbd->pad',
                                                                              pf1, mub)
        fb = torch.einsum('pab,pabd->pbd', pf2 * dota, delta) + torch.einsum('pab,pad->pbd',
                                                                              pf1, mua)
        dot_in = torch.einsum('mbd,mabd->mab', m4, din)
        f = (to_waters(fa, fb) + torch.einsum('mab,mabd->mad', pf2i * dot_in, din)
             + torch.einsum('mab,mbd->mad', pf1i, m4)).reshape(-1, 3)
        return f - pscale[None, :] * grid_.dipole_phi(mu)[:, 1:4] + self_term * mu

    # induced dipoles: SOR to the target, stopping also when it diverges
    e_alpha = efield.reshape(-1, 3) * pol[:, None]
    mu = e_alpha
    prev, it = math.inf, 0
    while True:
        dmu = e_alpha + field(mu) * pol[:, None] - mu
        mu = mu + SOR * dmu
        eps = float(SOR * DEBYE * torch.sqrt(torch.sum(dmu * dmu) / mu.shape[0]))
        it += 1
        if eps < scf_epsilon or prev < eps or it >= scf_max_iterations:
            break
        prev = eps
    m4 = mu.reshape(n, 4, 3)

    # direct energy, forces and potential
    mua, mub = m4[ia], m4[ib]
    dot_a = torch.einsum('pad,pabd->pab', mua, delta)
    dot_b = torch.einsum('pbd,pabd->pab', mub, delta)
    qq = qa[:, :, None] * qb[:, None, :]
    gli1 = qb[:, None, :] * dot_a - qa[:, :, None] * dot_b
    mumu = torch.einsum('pad,pbd->pab', mua, mub)
    e_pairs = torch.sum(w_((bn[0] - rr1 * (1.0 - s_cc[1])) * qq
                           + 0.5 * (bn[1] - rr3 * (1.0 - s_cd[3])) * gli1))
    coeff = w_((bn[1] - (1.0 - s_cc[3]) * rr3) * qq + (bn[2] - rr5 * (1.0 - s_cd[5])) * gli1
               + (bn[2] - rr5 * (1.0 - s_dd[5])) * mumu
               - (bn[3] - rr7 * (1.0 - s_dd[7])) * (dot_a * dot_b))
    F = (coeff[..., None] * delta + (w5 * dot_b)[..., None] * mua[:, :, None, :]
         + (w5 * dot_a)[..., None] * mub[:, None, :, :]
         + (w3 * qa[:, :, None])[..., None] * mub[:, None, :, :]
         - (w3 * qb[:, None, :])[..., None] * mua[:, :, None, :])
    force4 = to_waters(torch.sum(F, dim=2), -torch.sum(F, dim=1))
    pot4 = to_waters(torch.einsum('pab,pb->pa', k1, qb) - torch.sum(w3 * dot_b, dim=2),
                     torch.einsum('pab,pa->pb', k1, qa) + torch.sum(w3 * dot_a, dim=1))

    dot_i = torch.einsum('mbd,mabd->mab', m4, din)
    dot_ia = torch.einsum('mad,mabd->mab', m4, din)
    qqi = q4[:, :, None] * q4[:, None, :]
    glii = q4[:, None, :] * dot_ia - q4[:, :, None] * dot_i
    e_in = (bni[0] - inv_in) * qqi + 0.5 * (bni[1] - rr3i) * glii
    w5i = bni[2] - rr5i * (1.0 - sdi[5])
    w3i = bni[1] - rr3i
    coeff_i = (w3i * qqi + (bni[2] - rr5i) * glii + w5i * torch.einsum('mad,mbd->mab', m4, m4)
               - (bni[3] - rr7i * (1.0 - sdi[7])) * (dot_ia * dot_i))
    Fi = (coeff_i[..., None] * din + (w5i * dot_i)[..., None] * m4[:, :, None, :]
          + (w5i * dot_ia)[..., None] * m4[:, None, :, :]
          + (w3i * q4[:, :, None])[..., None] * m4[:, None, :, :]
          - (w3i * q4[:, None, :])[..., None] * m4[:, :, None, :])
    forces = -ELECTRIC * (force4 + torch.sum(Fi, dim=2)).reshape(-1, 3)
    pot = (pot4 + torch.einsum('mab,mb->ma', bni[0] - inv_in, q4)
           - torch.sum(w3i * dot_i, dim=2)).reshape(-1)

    # reciprocal fixed and induced, self
    e_recip = 0.5 * torch.sum(q * phi[:, 0])
    forces = forces - ELECTRIC * (q[:, None] * phi[:, 1:4] * pscale[None, :])
    pot = pot + phi[:, 0]
    phid = grid_.dipole_phi(mu)
    smu = mu * pscale[None, :]
    e_ind = 0.5 * torch.sum(smu * phi[:, 1:4])
    hess = torch.as_tensor(Grid.HESS, device=dev)
    f_ind = 2.0 * torch.einsum('ndk,nk->nd', phi[:, hess] + phid[:, hess], smu)
    f_ind = f_ind + 2.0 * q[:, None] * phid[:, 1:4]
    forces = forces - 0.5 * ELECTRIC * pscale[None, :] * f_ind
    pot = pot + phid[:, 0] - 2.0 * alpha / SQRT_PI * q
    e_self = -(alpha / SQRT_PI) * torch.sum(q * q)

    # the charges' geometry dependence
    f_q = -ELECTRIC * torch.einsum('masd,ms->mad', dq_w, pot.reshape(n, 4)[:, 1:])
    forces = forces.reshape(n, 4, 3) + torch.cat([f_q, torch.zeros_like(f_q[:, :1])], dim=1)
    energy = ELECTRIC * (e_pairs + 0.5 * torch.sum(e_in) + e_recip + e_ind + e_self)
    return energy, forces, (it, eps)
