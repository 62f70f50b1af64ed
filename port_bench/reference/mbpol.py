"""MB-pol energy and forces of a periodic water box, plain PyTorch.

Layout: 4 sites a water, [O, H1, H2, M]; nm, kJ/mol. `evaluate` builds its
lists from the oxygen positions (all water pairs under each cutoff by the
minimum image), places the M sites, evaluates the five terms and returns
them with the forces on the real atoms (the M-site share moved to O, H1 and
H2 with the virtual-site weights). The smooth terms take their forces from
autograd; the electrostatics' are explicit (`electrostatics.py`).

`dtype` float64 is the reference; the control runs the same code in
float32 with TF32 matrix products allowed (`control.py`).
"""
import numpy as np
import torch

from . import electrostatics
from .tables import KCAL_TO_KJ, NM_TO_ANGSTROM, load, scalars

DISP_MARGIN = 0.25          # nm: a water's sites lie within this of its O
PIP_CHUNK = 2048            # rows of the monomial expansion at a time
ROW_CHUNK = 1024            # rows of the O-O distance matrix at a time


# ---------------------------------------------------------------- geometry

def vsite_weights():
    return [float(w) for w in load('forcefield')['vsite_weights']]


def place_m_sites(pos4):
    """pos4 [n, 4, 3] with each M site at w1 O + w2 H1 + w3 H2."""
    w1, w2, w3 = vsite_weights()
    m = w1 * pos4[:, 0] + w2 * pos4[:, 1] + w3 * pos4[:, 2]
    return torch.cat([pos4[:, :3], m[:, None]], dim=1)


def whole(pos4, box):
    """Each water's H and M sites imaged next to its O."""
    o = pos4[:, :1]
    rest = pos4[:, 1:] + torch.floor((o - pos4[:, 1:]) / box + 0.5) * box
    return torch.cat([o, rest], dim=1)


def min_image(delta, box):
    return delta - torch.floor(delta / box + 0.5) * box


def image(ref, p, box):
    """p imaged next to ref."""
    return p + torch.floor((ref - p) / box + 0.5) * box


def water_pairs(o, box, cutoff):
    """[P, 2] water pairs i < j with minimum-image O-O distance < cutoff."""
    n = o.shape[0]
    out = []
    for r0 in range(0, n, ROW_CHUNK):
        d = min_image(o[None, :, :] - o[r0:r0 + ROW_CHUNK, None, :], box)
        r2 = torch.sum(d * d, dim=-1)
        i, j = torch.nonzero(r2 < cutoff * cutoff, as_tuple=True)
        i = i + r0
        keep = i < j
        out.append(torch.stack([i[keep], j[keep]], dim=1))
    return torch.cat(out)


def water_triplets(o, box, cutoff):
    """[T, 3] water triplets i < j < k with at least two O-O edges under
    cutoff, each once."""
    n = o.shape[0]
    p = water_pairs(o, box, cutoff)
    if p.shape[0] == 0:
        return torch.zeros((0, 3), dtype=torch.int64, device=o.device)
    centre = torch.cat([p[:, 0], p[:, 1]])
    other = torch.cat([p[:, 1], p[:, 0]])
    order = torch.argsort(centre * n + other)
    centre, other = centre[order], other[order]
    deg = torch.bincount(centre, minlength=n)
    kmax = int(deg.max())
    start = torch.cumsum(deg, 0) - deg
    slot = torch.arange(centre.shape[0], device=o.device) - start[centre]
    nb = torch.full((n, kmax), -1, dtype=torch.int64, device=o.device)
    nb[centre, slot] = other
    a, b = np.triu_indices(kmax, k=1)
    a = torch.as_tensor(a, device=o.device)
    b = torch.as_tensor(b, device=o.device)
    cb, cc = nb[:, a], nb[:, b]
    ca = torch.arange(n, device=o.device)[:, None].expand_as(cb)
    ok = (cb >= 0) & (cc >= 0)
    t = torch.stack([ca[ok], cb[ok], cc[ok]], dim=1)
    t = torch.sort(t, dim=1).values
    key = torch.unique((t[:, 0] * n + t[:, 1]) * n + t[:, 2])
    return torch.stack([key // (n * n), (key // n) % n, key % n], dim=1)


def safe_norm(d):
    return torch.sqrt(torch.clamp_min(torch.sum(d * d, dim=-1), 1e-12))


def cos_switch(r, r_lo, r_hi):
    """1 below r_lo, 0 above r_hi, a cosine between."""
    s = 0.5 * (1.0 + torch.cos((r - r_lo) * (np.pi / (r_hi - r_lo))))
    return torch.where(r > r_hi, 0.0, torch.where(r > r_lo, s, 1.0))


# ---------------------------------------------------------------- one-body

_F5Z, _FBASIS, _FCORE, _FREST = 0.999677885, 0.15860145369897, -1.6351695982132, 1.0
_COSTHE = -0.24780227221366464506
_CM1_SHIFT = 0.44739574026257
_MAX_POW = 15


def powers(x, n=_MAX_POW):
    """[..., n] x^0 .. x^(n-1) by repeated products (no NaN gradient at 0)."""
    cols = [torch.ones_like(x)]
    for _ in range(n - 1):
        cols.append(cols[-1] * x)
    return torch.stack(cols, dim=-1)


def _one_body_tables(dtype, device):
    d = load('onebody')
    c5z = _F5Z * d['c5zA'] + _FBASIS * d['cbasis'] + _FCORE * d['ccore'] + _FREST * d['crest']

    def onehot(idx):
        m = np.zeros((len(idx), _MAX_POW))
        m[np.arange(len(idx)), idx - 1] = 1.0
        return torch.as_tensor(m, dtype=dtype, device=device)

    return (float(c5z[0]), torch.as_tensor(c5z[1:], dtype=dtype, device=device),
            onehot(d['idx1'][1:]), onehot(d['idx2'][1:]), onehot(d['idx3'][1:]))


def one_body(w):
    """Partridge-Schwenke monomer energies [n] (kJ/mol) of w [n, 3, 3]."""
    t = scalars('onebody')
    c0, c5z, A1, A2, A3 = _one_body_tables(w.dtype, w.device)
    o, h1, h2 = w[:, 0], w[:, 1], w[:, 2]
    r1 = (h1 - o) * NM_TO_ANGSTROM
    r2 = (h2 - o) * NM_TO_ANGSTROM
    d1 = torch.linalg.norm(r1, dim=-1)
    d2 = torch.linalg.norm(r2, dim=-1)
    dhh = torch.linalg.norm((h1 - h2) * NM_TO_ANGSTROM, dim=-1)
    costh = torch.sum(r1 * r2, dim=-1) / (d1 * d2)
    deoh = _F5Z * t['deohA']
    phh1 = _F5Z * t['phh1A'] * np.exp(t['phh2'])
    e1 = torch.exp(-t['alphaoh'] * (d1 - t['roh']))
    e2 = torch.exp(-t['alphaoh'] * (d2 - t['roh']))
    va = deoh * (e1 * (e1 - 2.0) + e2 * (e2 - 2.0))
    vb = phh1 * torch.exp(-t['phh2'] * dhh)
    v1 = powers((d1 - t['reoh']) / t['reoh'])
    v2 = powers((d2 - t['reoh']) / t['reoh'])
    v3 = powers(costh - _COSTHE)
    s = (((v1 @ A1.T) * (v2 @ A2.T) + (v1 @ A2.T) * (v2 @ A1.T)) * (v3 @ A3.T)) @ c5z
    efac = torch.exp(-t['b1'] * ((d1 - t['reoh']) ** 2 + (d2 - t['reoh']) ** 2))
    e_cm1 = va + vb + 2.0 * c0 + efac * s + _CM1_SHIFT
    return e_cm1 * t['cm1_kcalmol'] * KCAL_TO_KJ


# ---------------------------------------------------------------- PIPs

class _Monomials(torch.autograd.Function):
    """E(x) = sum_m c_m prod_i x_i^e_mi over rows of x, in chunks of rows,
    with dE/dx = ((mono * c) @ E) / x kept for the backward."""

    @staticmethod
    def forward(ctx, x, E, c):
        es, gs = [], []
        logx = torch.log(x)
        for r0 in range(0, x.shape[0], PIP_CHUNK):
            mono = torch.exp(logx[r0:r0 + PIP_CHUNK] @ E.T)
            es.append(mono @ c)
            gs.append(((mono * c) @ E) / x[r0:r0 + PIP_CHUNK])
        ctx.save_for_backward(torch.cat(gs))
        return torch.cat(es)

    @staticmethod
    def backward(ctx, ge):
        (g,) = ctx.saved_tensors
        return ge[:, None] * g, None, None


def polynomial(name, x):
    """The poly2b / poly3b polynomial (kcal/mol) at rows of variables x."""
    if x.shape[0] == 0:
        return x.sum(dim=-1)
    d = load(name)
    E = torch.as_tensor(d['exponents'].astype(np.float64), dtype=x.dtype, device=x.device)
    c = torch.as_tensor(d['coeffs'], dtype=x.dtype, device=x.device)
    return _Monomials.apply(x, E, c)


def _lone_pairs(o, h1, h2, g_in, g_out):
    oh1, oh2 = h1 - o, h2 - o
    v = torch.cross(oh1, oh2, dim=-1)
    in_plane = o + (oh1 + oh2) * (0.5 * g_in)
    return in_plane + v * g_out, in_plane - v * g_out


def two_body(w, box, pairs):
    """The two-body energy (kJ/mol) of the water pairs [P, 2] of w [n, 3, 3]."""
    c = scalars('twobody_constants')
    bx = box * NM_TO_ANGSTROM
    wa = w[pairs[:, 0]] * NM_TO_ANGSTROM
    wb = w[pairs[:, 1]] * NM_TO_ANGSTROM
    oa = wa[:, 0]
    ha1, ha2 = image(oa, wa[:, 1], bx), image(oa, wa[:, 2], bx)
    ob = image(oa, wb[:, 0], bx)
    hb1, hb2 = image(ob, wb[:, 1], bx), image(ob, wb[:, 2], bx)
    roo = safe_norm(oa - ob)
    active = (roo < c['r2f']) & (roo > 2.0)
    far = torch.as_tensor([5.0, 0.0, 0.0], dtype=w.dtype, device=w.device)
    sub = (~active)[:, None]
    ob, hb1, hb2 = (torch.where(sub, p0 + far, p) for p0, p in ((oa, ob), (ha1, hb1),
                                                                (ha2, hb2)))
    xa1, xa2 = _lone_pairs(oa, ha1, ha2, c['in_plane_gamma'], c['out_of_plane_gamma'])
    xb1, xb2 = _lone_pairs(ob, hb1, hb2, c['in_plane_gamma'], c['out_of_plane_gamma'])

    def v_exp(k, p, q):
        return torch.exp(k * (1.0 - safe_norm(p - q)))

    def v_exp4(k, p, q):
        return torch.exp(k * (4.0 - safe_norm(p - q)))

    def v_coul(k, p, q):
        r = safe_norm(p - q)
        return torch.exp(k * (4.0 - r)) / r

    x = torch.stack([
        v_exp(c['k_HH_intra'], ha1, ha2), v_exp(c['k_HH_intra'], hb1, hb2),
        v_exp(c['k_OH_intra'], oa, ha1), v_exp(c['k_OH_intra'], oa, ha2),
        v_exp(c['k_OH_intra'], ob, hb1), v_exp(c['k_OH_intra'], ob, hb2),
        v_coul(c['k_HH_coul'], ha1, hb1), v_coul(c['k_HH_coul'], ha1, hb2),
        v_coul(c['k_HH_coul'], ha2, hb1), v_coul(c['k_HH_coul'], ha2, hb2),
        v_coul(c['k_OH_coul'], oa, hb1), v_coul(c['k_OH_coul'], oa, hb2),
        v_coul(c['k_OH_coul'], ob, ha1), v_coul(c['k_OH_coul'], ob, ha2),
        v_coul(c['k_OO_coul'], oa, ob),
        v_exp4(c['k_XH_main'], xa1, hb1), v_exp4(c['k_XH_main'], xa1, hb2),
        v_exp4(c['k_XH_main'], xa2, hb1), v_exp4(c['k_XH_main'], xa2, hb2),
        v_exp4(c['k_XH_main'], xb1, ha1), v_exp4(c['k_XH_main'], xb1, ha2),
        v_exp4(c['k_XH_main'], xb2, ha1), v_exp4(c['k_XH_main'], xb2, ha2),
        v_exp4(c['k_XO_main'], oa, xb1), v_exp4(c['k_XO_main'], oa, xb2),
        v_exp4(c['k_XO_main'], ob, xa1), v_exp4(c['k_XO_main'], ob, xa2),
        v_exp4(c['k_XX_main'], xa1, xb1), v_exp4(c['k_XX_main'], xa1, xb2),
        v_exp4(c['k_XX_main'], xa2, xb1), v_exp4(c['k_XX_main'], xa2, xb2),
    ], dim=-1)
    e = cos_switch(roo, c['r2i'], c['r2f']) * polynomial('poly2b', x)
    return torch.sum(torch.where(active, e, 0.0)) * KCAL_TO_KJ


def three_body(w, box, trips):
    """The three-body energy (kJ/mol) of the water triplets [T, 3] of w."""
    c = scalars('threebody_constants')
    bx = box * NM_TO_ANGSTROM
    ws = [w[trips[:, k]] * NM_TO_ANGSTROM for k in range(3)]
    oa = ws[0][:, 0]
    sites = []
    for k, wk in enumerate(ws):
        o = oa if k == 0 else image(oa, wk[:, 0], bx)
        sites.append([o, image(o, wk[:, 1], bx), image(o, wk[:, 2], bx)])
    rab = safe_norm(sites[0][0] - sites[1][0])
    rac = safe_norm(sites[0][0] - sites[2][0])
    rbc = safe_norm(sites[1][0] - sites[2][0])
    active = (rab > 2.0) & (rac > 2.0) & (rbc > 2.0)
    sub = (~active)[:, None]
    for k, shift in ((1, (4.0, 0.0, 0.0)), (2, (0.0, 4.0, 0.0))):
        s = torch.as_tensor(shift, dtype=w.dtype, device=w.device)
        sites[k] = [torch.where(sub, p0 + s, p) for p0, p in zip(sites[0], sites[k])]
    (oa, ha1, ha2), (ob, hb1, hb2), (oc, hc1, hc2) = sites

    def v(k, d0, p, q):
        return torch.exp(-k * (safe_norm(p - q) - d0))

    hhi, ohi = (c['kHH_intra'], c['dHH_intra']), (c['kOH_intra'], c['dOH_intra'])
    hh, oh, oo = (c['kHH'], c['dHH']), (c['kOH'], c['dOH']), (c['kOO'], c['dOO'])
    x = torch.stack([
        v(*hhi, ha1, ha2), v(*hhi, hb1, hb2), v(*hhi, hc1, hc2),
        v(*ohi, oa, ha1), v(*ohi, oa, ha2), v(*ohi, ob, hb1), v(*ohi, ob, hb2),
        v(*ohi, oc, hc1), v(*ohi, oc, hc2),
        v(*hh, ha1, hb1), v(*hh, ha1, hb2), v(*hh, ha1, hc1), v(*hh, ha1, hc2),
        v(*hh, ha2, hb1), v(*hh, ha2, hb2), v(*hh, ha2, hc1), v(*hh, ha2, hc2),
        v(*hh, hb1, hc1), v(*hh, hb1, hc2), v(*hh, hb2, hc1), v(*hh, hb2, hc2),
        v(*oh, oa, hb1), v(*oh, oa, hb2), v(*oh, oa, hc1), v(*oh, oa, hc2),
        v(*oh, ob, ha1), v(*oh, ob, ha2), v(*oh, ob, hc1), v(*oh, ob, hc2),
        v(*oh, oc, ha1), v(*oh, oc, ha2), v(*oh, oc, hb1), v(*oh, oc, hb2),
        v(*oo, oa, ob), v(*oo, oa, oc), v(*oo, ob, oc),
    ], dim=-1)
    sab, sac, sbc = (cos_switch(r, c['r3i'], c['r3f']) for r in (rab, rac, rbc))
    e = (sab * sac + sab * sbc + sac * sbc) * polynomial('poly3b', x)
    return torch.sum(torch.where(active, e, 0.0)) * KCAL_TO_KJ


# ---------------------------------------------------------------- dispersion

def tt6(x):
    """Order-6 Tang-Toennies damping."""
    s = 1.0 / 720.0
    for k in (120.0, 24.0, 6.0, 2.0, 1.0, 1.0):
        s = s * x + 1.0 / k
    return 1.0 - torch.exp(-x) * s


def dispersion(w, box, pairs, cutoff, width):
    """TT6 C6 dispersion (kJ/mol) over the real sites of the water pairs
    [P, 2] (each unordered pair once), cut at `cutoff` with the C2 switch
    over its last `width` nm."""
    ff = load('forcefield')
    cls = np.array([0, 1, 1])
    C6 = torch.as_tensor(ff['C6'][np.ix_(cls, cls)], dtype=w.dtype, device=w.device)
    d6 = torch.as_tensor(ff['d6'][np.ix_(cls, cls)], dtype=w.dtype, device=w.device)
    pa, pb = w[pairs[:, 0]], w[pairs[:, 1]]
    delta = min_image(pb[:, None, :, :] - pa[:, :, None, :], box)
    r2 = torch.sum(delta * delta, dim=-1)
    inside = r2 < cutoff * cutoff
    r2 = torch.where(inside, r2, 1.0)
    r = torch.sqrt(r2)
    e = -C6 * tt6(d6 * r) / (r2 * r2 * r2)
    x = torch.clamp((r - (cutoff - width)) / width, 0.0, 1.0)
    e = e * (1.0 - x * x * x * (10.0 + x * (-15.0 + 6.0 * x)))
    return torch.sum(torch.where(inside, e, 0.0))


# ---------------------------------------------------------------- all terms

TERMS = ('one_body', 'two_body', 'three_body', 'dispersion', 'electrostatics')


def evaluate(positions, box, settings, dtype=torch.float64, device=None, scf_epsilon=1e-8,
             scf_max_iterations=500):
    """{'terms': {name: kJ/mol}, 'energy': kJ/mol, 'forces': [4n, 3] kJ/mol/nm
    (M rows zero), 'scf': (iterations, epsilon)} of the water box.

    positions: [4n, 3] nm ([O, H1, H2, M] per water; the M rows are placed
    here); box: three floats, nm; settings: the configuration's numbers
    (cutoff, ewald_error_tolerance, dispersion_switch_width, cutoff_2b,
    cutoff_3b)."""
    device = torch.device('cpu') if device is None else torch.device(device)
    pos = torch.as_tensor(np.asarray(positions), dtype=dtype, device=device)
    n = pos.shape[0] // 4
    bx = torch.as_tensor(np.asarray(box, np.float64), dtype=dtype, device=device)
    p4 = whole(pos.reshape(n, 4, 3), bx)
    cut = float(settings['cutoff'])
    with torch.no_grad():
        o = p4[:, 0]
        p2 = water_pairs(o, bx, float(settings['cutoff_2b']))
        t3 = water_triplets(o, bx, float(settings['cutoff_3b']))
        pd = water_pairs(o, bx, cut + DISP_MARGIN)
    terms = {}
    with torch.enable_grad():
        p = p4.detach().clone().requires_grad_(True)
        w = place_m_sites(p)[:, :3]
        terms['one_body'] = torch.sum(one_body(w))
        terms['two_body'] = two_body(w, bx, p2)
        terms['three_body'] = three_body(w, bx, t3)
        terms['dispersion'] = dispersion(w, bx, pd, cut, float(settings['dispersion_switch_width']))
        smooth = sum(terms.values())
        grad = torch.autograd.grad(smooth, p)[0]
    forces = -grad
    with torch.no_grad():
        sites = place_m_sites(p4)
        e_el, f_el, scf = electrostatics.pme_energy_forces(
            sites, bx, pd, cut, float(settings['ewald_error_tolerance']), scf_epsilon,
            scf_max_iterations)
        w1, w2, w3 = vsite_weights()
        f_m = f_el[:, 3]
        f_el = torch.stack([f_el[:, 0] + w1 * f_m, f_el[:, 1] + w2 * f_m,
                            f_el[:, 2] + w3 * f_m, torch.zeros_like(f_m)], dim=1)
        forces = forces + f_el
    terms = {k: float(v.detach()) for k, v in terms.items()}
    terms['electrostatics'] = float(e_el)
    return dict(terms=terms, energy=sum(terms.values()), forces=forces.reshape(-1, 3),
                scf=scf)
