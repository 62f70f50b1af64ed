"""PME electrostatics, dense and block-sparse direct space
(port of the single-device dense and block branches of
mbpol_openmm_plugin_tpu/models/pme.py; the sparse direct space is
models/pme_sparse.py, over the grid pieces of this module).

- order-5 B-spline spreading onto a 3D grid through separable one-hot
  spline matrices, FFT convolution with the B-spline moduli and
  exp(-pi^2 m^2/alpha^2), read-back of the potential and its derivatives;
  above _SEP_CHUNK_ELEMS elements per temporary the spread and the
  read-back run over chunks of sites in a fixed order;
- direct-space pair work in ops/elec_direct (dense: [N, N] SCF factor
  matrices) or ops/elec_direct_bs (block: sites sorted by a static
  permutation, s3/s5 kept only for the live (water, 32-site cluster)
  lines of the active 256 x 256 tile pairs, and the SCF dipole field
  through the block kernel); CUDA kernels on the card, plain twins on the
  CPU;
- induced-dipole SCF with direct + reciprocal + self fields, self energy,
  and charge-derivative forces from the per-site potential.

The box is an input of every evaluation (`box`, a host float64 triple;
default the setup's): the spline fractions, the reciprocal kernel, the
grid scale, the minimum images and the tile-pair list follow it, and the
direct-space kernels take it by value, so a barostat's volume move needs no
rebuild. The grid dimensions and alpha stay at their construction values.

Under a device mesh (`mesh`, parallel/mesh.py; JAX pme.py's `sharded` and
`bs_sharded` paths) the dense direct space runs the full-grid row kernels
(#3/#4) over each shard's slab of the padded rows, the SCF's dipole field
runs slab by slab on the shards' devices and is gathered on the lead; the
block path gives each shard its slab of row tiles and a local tile list;
and the reciprocal pipeline splits its sites: each shard spreads its sites
into a partial grid, the partial grids are added on the lead in shard
order, the convolution runs there once and each shard reads back its
sites (`_Grid`).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from mbpol_openmm_plugin_tpu_torch.models import electrostatics as elec
from mbpol_openmm_plugin_tpu_torch.ops import elec_direct
from mbpol_openmm_plugin_tpu_torch.ops import elec_direct_bs as bs
from mbpol_openmm_plugin_tpu_torch.ops.bspline import ORDER, bspline5, bspline_moduli
from mbpol_openmm_plugin_tpu_torch.system import box_tensor
from mbpol_openmm_plugin_tpu_torch.utils import tracing, units
from mbpol_openmm_plugin_tpu_torch.utils.consts import cached, device_const

_SQRT_PI = np.sqrt(np.pi)
_NDERIV = 3   # spline value + 1st + 2nd derivative


@dataclasses.dataclass(frozen=True)
class PmeSetup:
    """Static PME configuration."""
    alpha: float                 # Ewald splitting parameter, 1/nm
    grid: tuple                  # (nx, ny, nz)
    cutoff: float                # direct-space cutoff, nm
    box: tuple                   # (lx, ly, lz) nm

    @classmethod
    def from_config(cls, system, config):
        """alpha/grid from the Ewald error tolerance when unset (OpenMM's
        NonbondedForceImpl::calcPMEParameters)."""
        tol = config.ewald_error_tolerance
        cutoff = config.cutoff
        box = tuple(float(b) for b in system.box)
        alpha = config.ewald_alpha
        if alpha is None:
            alpha = np.sqrt(-np.log(2.0 * tol)) / cutoff
        grid = config.pme_grid
        if grid is None:
            grid = tuple(int(np.ceil(2.0 * alpha * b / (3.0 * tol ** 0.2))) for b in box)
        return cls(alpha=float(alpha), grid=tuple(int(g) for g in grid),
                   cutoff=float(cutoff), box=box)


def box_tuple(setup: PmeSetup, box=None):
    """The evaluation's box as a tuple of three floats (default the
    setup's)."""
    return setup.box if box is None else tuple(float(b) for b in box)


def _spline_matrices(setup: PmeSetup, positions, box):
    """Separable one-hot spline matrices (Sx [N, nx, 3], Sy [N, ny, 3],
    Sz [N, nz, 3]) in the box `box` (a tuple): S[n, g, d] = d-th derivative
    coefficient of site n's B-spline at grid line g (zero outside its
    5-point support). A tensor box stays differentiable."""
    dt, dev = positions.dtype, positions.device
    dims_i = device_const(setup.grid, device=dev)
    dims = dims_i.to(dt)
    box = box_tensor(box, positions)
    pos = positions - torch.floor(positions / box + 0.5) * box
    fr = dims * (pos / box + 0.5)
    ifr = torch.floor(fr)
    wfrac = fr - ifr
    igrid = torch.remainder(ifr.to(torch.int64) - (ORDER - 1), dims_i)
    theta = bspline5(wfrac)[..., :_NDERIV]        # [N, 3, 5, 3]
    off = torch.arange(ORDER, device=dev)
    out = []
    for axis, nax in enumerate(setup.grid):
        lines = torch.remainder(igrid[:, axis:axis + 1] + off[None], nax)     # [N, 5]
        onehot = (lines[:, :, None] == torch.arange(nax, device=dev)).to(dt)
        out.append(torch.einsum('nkg,nkd->ngd', onehot, theta[:, axis]))
    return tuple(out)


# The separable pieces materialize [rows, ny*nz] (spread) and
# [rows, 3, nx*ny] (read-back) temporaries: megabytes at water256, but at
# 32,768 sites on a ~106^3 grid 1.5-4.4 GB each. Above this element budget
# (2^26 float32 elements, 256 MB per temporary) the site dimension is
# chunked: the spread accumulates chunk by chunk into one grid, in a fixed
# order, and the read-back concatenates the chunks' rows.
_SEP_CHUNK_ELEMS = 1 << 26


def _sep_chunk(n, per_site_elems):
    """Rows per chunk for n rows of per_site_elems temporary elements each
    (n: no chunking)."""
    if n * per_site_elems <= _SEP_CHUNK_ELEMS:
        return n
    return min(max(_SEP_CHUNK_ELEMS // per_site_elems, 256), n)


def _spread_separable(setup, wx, sy, sz):
    """grid[g,h,k] = sum_n wx[n,g] sy[n,h] sz[n,k] as one matmul, or as one
    per chunk of rows added into the grid in row order."""
    nx, ny, nz = setup.grid
    n = wx.shape[0]
    c = _sep_chunk(n, ny * nz)
    grid = None
    for r0 in range(0, n, c):
        a = torch.einsum('nh,nk->nhk', sy[r0:r0 + c], sz[r0:r0 + c]).reshape(-1, ny * nz)
        part = wx[r0:r0 + c].T @ a
        grid = part if grid is None else grid + part
    return grid.reshape(nx, ny, nz)


# phi component layout of the reference (cpp:1800-1819):
# 0:000 1:100 2:010 3:001 4:200 5:020 6:002 7:110 8:101 9:011
_PHI_COMP = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (2, 0, 0),
             (0, 2, 0), (0, 0, 2), (1, 1, 0), (1, 0, 1), (0, 1, 1)]
# Hessian component indices into phi10, per force dim
_HESS = [[4, 7, 8], [7, 5, 9], [8, 9, 6]]


def _readback_phi10(grid, Sx, Sy, Sz):
    """phi10[n, q] = sum_{ghk} grid[g,h,k] Sx[n,g,a_q] Sy[n,h,b_q] Sz[n,k,c_q]:
    the z contraction as [n, nz] @ [nz, nx*ny] matmuls, then multiply-reduces
    over y and x; over chunks of sites above the temporary budget."""
    n = Sx.shape[0]
    nx, ny, nz = grid.shape
    gz = grid.reshape(nx * ny, nz).T
    pairs = sorted({(b, c) for _, b, c in _PHI_COMP})

    def block(Sxc, Syc, Szc):
        m = Sxc.shape[0]
        t1 = [(Szc[:, :, c] @ gz).reshape(m, nx, ny) for c in range(_NDERIV)]
        t2 = {(b, c): torch.sum(t1[c] * Syc[:, None, :, b], dim=-1) for (b, c) in pairs}
        return torch.stack([torch.sum(t2[(b, c)] * Sxc[:, :, a], dim=-1)
                            for a, b, c in _PHI_COMP], dim=-1)

    c = _sep_chunk(n, _NDERIV * nx * ny)
    if c >= n:
        return block(Sx, Sy, Sz)
    return torch.cat([block(Sx[r0:r0 + c], Sy[r0:r0 + c], Sz[r0:r0 + c])
                      for r0 in range(0, n, c)])


@functools.lru_cache(maxsize=None)
def _eterm_static(setup: PmeSetup):
    """m-vector grids and 1/(B-spline modulus product). The reciprocal form:
    near the Nyquist modes of an odd-order spline the product b overflows
    float32 (~1e51); 1/b underflows cleanly to 0, the correct limit."""
    mods = bspline_moduli(setup.grid)

    def mvec(n):
        k = np.arange(n)
        return np.where(k < (n + 1) // 2, k, k - n).astype(np.float64)

    b = mods[0][:, None, None] * mods[1][None, :, None] * mods[2][None, None, :]
    return tuple(mvec(n) for n in setup.grid) + (1.0 / b,)


def _eterm_of(setup: PmeSetup, b):
    """Reciprocal convolution kernel on the grid for the box tensor b [3]
    (differentiable in b), in b's dtype and on its device."""
    mx, my, mz, binv = (device_const(a, dtype=b.dtype, device=b.device)
                        for a in _eterm_static(setup))
    m2 = ((mx / b[0])[:, None, None] ** 2 + (my / b[1])[None, :, None] ** 2
          + (mz / b[2])[None, None, :] ** 2)
    expfac = np.pi * np.pi / (setup.alpha * setup.alpha)
    scale = 1.0 / (np.pi * b[0] * b[1] * b[2])
    m2safe = torch.where(m2 > 0, m2, 1.0)
    return torch.where(m2 > 0, scale * torch.exp(-expfac * m2safe) / m2safe * binv, 0.0)


def _eterm(setup: PmeSetup, box, dtype, device):
    """`_eterm_of` the box `box` (a tuple) in float64 on the host, then
    cast. Cached per box (utils/consts.py): under a barostat the box
    changes only on an accepted move, and a move evaluates the old and the
    trial box."""
    def build():
        b = torch.as_tensor(np.asarray(box, np.float64))
        return _eterm_of(setup, b).to(dtype=dtype, device=device)
    return cached(('eterm', setup, tuple(box), dtype, torch.device(device)), build)


def _convolve(setup: PmeSetup, grid, box):
    """Forward FFT, eterm multiply, unnormalized backward FFT (ifftn * Ntot,
    the reference fftpack convention). box: a tuple, or a tensor (then
    differentiable)."""
    ntot = grid.numel()
    et = (_eterm_of(setup, box) if isinstance(box, torch.Tensor)
          else _eterm(setup, box, grid.dtype, grid.device))
    gk = torch.fft.fftn(grid) * et
    return torch.real(torch.fft.ifftn(gk) * ntot)


def _dipole_sources(smu, S):
    """The spread sources (wx, sy, sz) of the scaled dipoles smu [N, 3] on
    the spline matrices S: the three derivative sources concatenated, so
    they spread as one matmul."""
    Sx, Sy, Sz = S
    sx0, sy0, sz0 = Sx[..., 0], Sy[..., 0], Sz[..., 0]
    sx1, sy1, sz1 = Sx[..., 1], Sy[..., 1], Sz[..., 1]
    wx = torch.cat([smu[:, 0:1] * sx1, smu[:, 1:2] * sx0, smu[:, 2:3] * sx0], dim=0)
    return wx, torch.cat([sy0, sy1, sy0], dim=0), torch.cat([sz0, sz0, sz1], dim=0)


def _dipole_phi(setup: PmeSetup, mu, pscale, S, box):
    """Reciprocal phi10 [N, 10] of the dipoles mu [N, 3] on the spline
    matrices S = (Sx, Sy, Sz)."""
    g = _spread_separable(setup, *_dipole_sources(mu * pscale[None, :], S))
    return _readback_phi10(_convolve(setup, g, box), *S)


class _Grid:
    """The reciprocal pipeline over the sites of positions [N, 3] in `box`:
    the spline matrices of each shard's sites on its device (one part on
    the positions' device without a mesh). phi10 of a source: each part
    spreads its sites into a partial grid, the grids are added on the lead
    device in shard order, the convolution runs there once, and each part
    reads back its sites; one part gives the single-device bits."""

    def __init__(self, setup: PmeSetup, positions, box, mesh=None):
        self.setup, self.box, self.lead = setup, box, positions.device
        if mesh is None:
            self.parts = [(positions.device, 0, positions.shape[0],
                           _spline_matrices(setup, positions, box))]
        else:
            from mbpol_openmm_plugin_tpu_torch.parallel import mesh as M
            self.parts = M.map_rows(mesh, positions.shape[0], lambda dev, lo, hi: (
                dev, lo, hi, _spline_matrices(setup, positions[lo:hi].to(dev), box)))

    def _phi10(self, sources):
        from mbpol_openmm_plugin_tpu_torch.parallel.mesh import on_shard
        grid = None
        for dev, lo, hi, S in self.parts:
            with on_shard(dev):
                g = _spread_separable(self.setup, *sources(lo, hi, dev, S)).to(self.lead)
            grid = g if grid is None else grid + g
        conv = _convolve(self.setup, grid, self.box)
        out = []
        for dev, lo, hi, S in self.parts:
            with on_shard(dev):
                out.append(_readback_phi10(conv.to(dev), *S))
        return out[0] if len(out) == 1 else torch.cat([o.to(self.lead) for o in out])

    def charge_phi(self, charges):
        """phi10 [N, 10] of the charges [N]."""
        return self._phi10(lambda lo, hi, dev, S: (charges[lo:hi, None].to(dev) * S[0][..., 0],
                                                   S[1][..., 0], S[2][..., 0]))

    def dipole_phi(self, mu, pscale):
        """phi10 [N, 10] of the dipoles mu [N, 3] (_dipole_phi)."""
        smu = mu * pscale[None, :]
        return self._phi10(lambda lo, hi, dev, S: _dipole_sources(smu[lo:hi].to(dev), S))


def block_info(site_perm, capacity, device, line_capacity=None, capacity_local=None):
    """The block-mode layout: the static site permutation (numpy and on
    `device`, with its inverse), the tile-pair list capacity, the per-shard
    local list capacity under a mesh (None: derived from the global one)
    and the s3/s5 line capacity per (row water, cluster) slab (None: the
    number of column tiles, which never overflows)."""
    site_perm = np.asarray(site_perm, np.int64)
    inv = np.empty_like(site_perm)
    inv[site_perm] = np.arange(len(site_perm))
    if line_capacity is None:
        line_capacity = bs.default_line_capacity(bs.padded(len(site_perm)))
    return dict(site_perm=site_perm, site_perm_inv=inv, tile_pair_capacity=int(capacity),
                tile_pair_capacity_local=None if capacity_local is None else int(capacity_local),
                line_capacity=int(line_capacity),
                perm=torch.as_tensor(site_perm, device=device),
                inv=torch.as_tensor(inv, device=device))


def site_tables(params: elec.ElecParams, dtype, device):
    """The per-site tables of the direct space and the SCF on the device:
    damping^(-1/6), molecule ids, oxygen flags and polarizabilities (MBPol
    builds them once and passes them in)."""
    return dict(
        d16_inv=torch.as_tensor(np.asarray(params.damping, np.float64) ** (-1.0 / 6.0),
                                dtype=dtype, device=device),
        mol=torch.as_tensor(np.asarray(params.mol_index), device=device),
        is_o=torch.as_tensor(np.asarray(params.atom_type) == 0, device=device),
        polarity=torch.as_tensor(params.polarity, dtype=dtype, device=device))


def local_tile_capacity(block, n_shards):
    """The per-shard tile-pair list capacity of a block layout: the global
    one for one shard; else its own, or the JAX package's default from the
    global capacity."""
    if n_shards == 1:
        return block['tile_pair_capacity']
    return (block['tile_pair_capacity_local']
            or (block['tile_pair_capacity'] * 13) // (10 * n_shards) + 8)


def block_sites(params: elec.ElecParams, setup: PmeSetup, positions, charges, block,
                tables=None, box=None, mesh=None):
    """Block mode's direct-space inputs: the packed sites in the static
    sorted order, padded to parallel.mesh.padded_for_mesh (whole tiles
    without a mesh), and the active tile-pair lists in `box` (default the
    setup's), one local list per shard in shard order (mesh None: one part
    on the positions' device)."""
    from mbpol_openmm_plugin_tpu_torch.parallel import mesh as M
    mesh = M.or_one(mesh, positions.device)
    if tables is None:
        tables = site_tables(params, positions.dtype, positions.device)
    d16_inv, mol, is_o = tables['d16_inv'], tables['mol'], tables['is_o']
    perm, n, box = block['perm'], positions.shape[0], box_tuple(setup, box)
    sites = bs.pack_sites(positions[perm], charges[perm], d16_inv[perm], mol[perm], is_o[perm],
                          pad_to=M.padded_for_mesh(n, mesh.size))
    return sites, bs.active_tile_pairs_sharded(sites[:, :3], n, box, setup.cutoff,
                                               local_tile_capacity(block, mesh.size), mesh)


def _dense_direct(sites, positions, consts, box, mesh):
    """The dense direct space: (fixed field [N, 3], direct_field(mu),
    direct_efp(mu)) through K1/K2, or under a mesh through the full-grid
    row kernels, each shard holding its s3/s5/delta slab of the padded
    rows [N_pad / size, N_pad] on its device."""
    n = positions.shape[0]
    if mesh is None:
        ef_direct, s3_dir, s5_dir = elec_direct.fixed_field_and_scf_factors(sites, consts)
        delta = elec_direct.pair_delta(positions, box)

        def direct_field(mu):
            return elec.dipole_field(mu, s3_dir, s5_dir, delta)

        def direct_efp(mu):
            return elec_direct.direct_energy_force_pot(sites, mu.contiguous(), consts)
        return ef_direct, direct_field, direct_efp

    from mbpol_openmm_plugin_tpu_torch.parallel import mesh as M
    ef_direct, s3, s5 = elec_direct.fixed_field_and_scf_factors_sharded(sites, consts, mesh)
    n_pad = M.padded_for_mesh(n, mesh.size)
    pos_pad = bs.pad_rows(positions, n_pad)
    # the slabs holding real rows (one of padding rows only adds nothing to [:n])
    slabs = [(dev, lo, hi, s3_k, s5_k) for dev, (lo, hi), s3_k, s5_k
             in zip(mesh.devices, M.row_ranges(n_pad, mesh), s3, s5) if lo < n]
    deltas = []
    for dev, lo, hi, _, _ in slabs:
        with M.on_shard(dev):
            p = pos_pad.to(dev)
            deltas.append(elec_direct._delta(p[lo:hi], p, box))

    def direct_field(mu):
        mu_pad = bs.pad_rows(mu, n_pad)
        out = []
        for (dev, _, _, s3_k, s5_k), d_k in zip(slabs, deltas):
            with M.on_shard(dev):
                out.append(elec.dipole_field(mu_pad.to(dev), s3_k, s5_k, d_k))
        return M.gather_rows(mesh, out)[:n]

    def direct_efp(mu):
        return elec_direct.direct_energy_force_pot_sharded(sites, mu.contiguous(), consts, mesh)
    return ef_direct, direct_field, direct_efp


def pme_electrostatics(params: elec.ElecParams, setup: PmeSetup, positions, mu0=None,
                       block=None, tables=None, box=None, mesh=None):
    """PME energy (kJ/mol), forces (kJ/mol/nm) and diagnostics.

    positions: [N,3] nm with M sites placed; mu0: optional dipole predictor
    (ASPC) or warm start; block: a `block_info` dict for the block-sparse
    direct space (None: dense); tables: `site_tables` of params on the
    positions' device (built here when None); box: the evaluation's box
    (three floats; default setup.box); mesh: a parallel.mesh.Mesh whose
    lead device is the positions' (None: one device). Block mode never
    builds an [N, N] tensor and adds elec_tile_pairs / elec_tile_overflow /
    elec_line_overflow to the diagnostics.
    """
    dt, dev = positions.dtype, positions.device
    f_elec = units.ELECTRIC
    alpha = setup.alpha
    box = box_tuple(setup, box)
    pscale = (device_const(setup.grid, dtype=dt, device=dev)
              / device_const(box, dtype=dt, device=dev))

    charges, dq_w = elec.assemble_charges(params, positions)
    if tables is None:
        tables = site_tables(params, dt, dev)
    alpha_pol = tables['polarity']

    # ---- direct space: K1 (fixed field + SCF factors) ----
    consts = elec_direct.DirectConsts.from_setup(setup, params.thole, box)
    n = positions.shape[0]
    bs_diag = {}
    if block is None:
        sites = elec_direct.pack_sites(positions, charges, tables['d16_inv'], tables['mol'],
                                       tables['is_o'])
        ef_direct, direct_field, direct_efp = _dense_direct(sites, positions, consts, box, mesh)
    else:
        from mbpol_openmm_plugin_tpu_torch.parallel import mesh as M
        bmesh = M.or_one(mesh, dev)
        perm, inv = block['perm'], block['inv']
        with tracing.span('models.pme.block_sites'):
            sites, tiles = block_sites(params, setup, positions, charges, block, tables, box,
                                       bmesh)
        with tracing.span('models.pme.block_lines'):
            ef_s, lines = bs.fixed_field_and_scf_lines_sharded(sites, n, tiles, consts,
                                                               block['line_capacity'], bmesh)
        bs_diag = dict(
            elec_tile_pairs=M.sum_to_lead(bmesh, [t.n_act for t in tiles]),
            elec_tile_overflow=M.any_to_lead(bmesh, [t.n_act > t.capacity for t in tiles]),
            elec_line_overflow=M.any_to_lead(bmesh, [ln.overflow() for ln in lines]))
        ef_direct = ef_s[inv]

        def direct_field(mu):
            mu_pad = bs.pad_rows(mu[perm], sites.shape[0])
            return bs.scf_dipole_field_bs_sharded(sites, lines, mu_pad, tiles, n, consts,
                                                  bmesh)[inv]

        def direct_efp(mu):
            e, f_s, pot_s = bs.direct_energy_force_pot_bs_sharded(
                sites, mu[perm].contiguous(), n, tiles, consts, bmesh)
            return e, f_s[inv], pot_s[inv]

    # ---- grid machinery ----
    rgrid = _Grid(setup, positions, box, mesh)
    phi = rgrid.charge_phi(charges)                                     # [N,10]

    # ---- fixed field: reciprocal + direct ----
    efield = -pscale[None, :] * phi[:, 1:4] + ef_direct

    # ---- SCF ----
    self_term = (4.0 / 3.0) * alpha ** 3 / _SQRT_PI

    def field_fn(mu):
        f = direct_field(mu)
        phid = rgrid.dipole_phi(mu, pscale)
        return f + (-pscale[None, :] * phid[:, 1:4] + self_term * mu)

    scf = elec.make_scf(params)
    mu, diag = scf(efield * alpha_pol[:, None], alpha_pol, field_fn,
                   params.target_epsilon, params.max_iterations, mu0=mu0)

    diag = dict(diag, **bs_diag)

    # ---- direct-space energy/forces/potential: K2 ----
    e_direct, force_pair, pot = direct_efp(mu)
    forces = -f_elec * force_pair

    # ---- reciprocal fixed ----
    e_recip_fixed = 0.5 * torch.sum(charges * phi[:, 0])
    forces = forces - f_elec * (charges[:, None] * phi[:, 1:4] * pscale[None, :])
    pot = pot + phi[:, 0]

    # ---- reciprocal induced ----
    phid = rgrid.dipole_phi(mu, pscale)
    smu = mu * pscale[None, :]
    e_recip_ind = 0.5 * torch.sum(smu * phi[:, 1:4])
    hess = device_const(_HESS, device=dev)
    f_ind = 2.0 * torch.einsum('ndk,nk->nd', phi[:, hess] + phid[:, hess], smu)
    f_ind = f_ind + 2.0 * charges[:, None] * phid[:, 1:4]
    forces = forces - 0.5 * f_elec * pscale[None, :] * f_ind
    pot = pot + phid[:, 0]

    # ---- self ----
    e_self = -(alpha / _SQRT_PI) * torch.sum(charges * charges)
    pot = pot + charges * (-2.0 * alpha / _SQRT_PI)

    # ---- charge-derivative forces ----
    if params.include_charge_redistribution and dq_w is not None:
        forces = forces + elec.charge_derivative_forces(params, pot, dq_w)

    energy = f_elec * (e_direct + e_recip_fixed + e_recip_ind + e_self)
    return energy, forces, dict(**diag, charges=charges, induced_dipoles=mu,
                                site_potential=pot)


def _direct_variational_rows(sites, mu, c, r0, r1):
    """Rows r0:r1 of the direct space's share of `pme_variational_energy`
    (Coulomb units): the plain formulas of K1 and K2 (ops/elec_direct.py)
    between those sites and all sites, with c.box possibly a tensor."""
    n = sites.shape[0]
    rows = torch.arange(r0, r1, device=sites.device)
    notself = rows[:, None] != torch.arange(n, device=sites.device)[None, :]
    srow, mrow = sites[r0:r1], mu[r0:r1]
    t = elec_direct._pair_terms(srow, sites, notself, c, need_cc1=True)
    kdir, s3, s5 = elec_direct._k1_pair(t)
    q = sites[:, elec_direct._Q]
    field = -torch.einsum('ij,j,ijd->id', kdir, q, t['delta'])
    t_mu = elec.dipole_field(mu, s3, s5, t['delta'])
    k1 = elec_direct._k2_pair(t, srow, sites, mrow, mu)['k1']
    e_perm = 0.5 * torch.sum(srow[:, elec_direct._Q] * (k1 @ q))
    return e_perm - torch.sum(mrow * field) - 0.5 * torch.sum(mrow * t_mu)


def pme_variational_energy(params: elec.ElecParams, setup: PmeSetup, positions, mu, box,
                           tables=None):
    """The polarizable PME energy (kJ/mol) as a function of the induced
    dipoles mu [N, 3]:
        U(mu) = E_perm - mu . E_fixed + 1/2 mu . alpha^-1 mu - 1/2 mu . T mu
    (T mu: the dipole field of `pme_electrostatics`' SCF, direct +
    reciprocal + self). At the SCF's fixed point U equals the energy of
    `pme_electrostatics` and is stationary in mu, so with mu held there
    its derivative in positions or box is the total derivative of the
    converged energy. positions: [N, 3] nm with M sites placed; box: three
    floats or a tensor [3], differentiable with the positions. No kernel:
    the direct space is the dense plain formula over rows of
    elec_direct.TRI_CHUNK site pairs, each under activation checkpointing
    (one chunk's intermediates in memory at a time). md/pressure.py takes
    dU/dlambda through it."""
    dt, dev = positions.dtype, positions.device
    b = box_tensor(box if isinstance(box, torch.Tensor) else box_tuple(setup, box), positions)
    alpha = setup.alpha
    charges, _ = elec.assemble_charges(params, positions)
    if tables is None:
        tables = site_tables(params, dt, dev)
    alpha_pol = tables['polarity']
    mu = mu.detach()

    # direct space, the box as a tensor in the constants
    c = dataclasses.replace(elec_direct.DirectConsts.from_setup(setup, params.thole), box=b)
    sites = elec_direct.pack_sites(positions, charges, tables['d16_inv'], tables['mol'],
                                   tables['is_o'])
    n = positions.shape[0]
    step = max(1, elec_direct.TRI_CHUNK // n)
    e = sum(checkpoint(_direct_variational_rows, sites, mu, c, r0, min(r0 + step, n),
                       use_reentrant=False) for r0 in range(0, n, step))

    # reciprocal space
    pscale = device_const(setup.grid, dtype=dt, device=dev) / b
    S = _spline_matrices(setup, positions, b)
    grid = _spread_separable(setup, charges[:, None] * S[0][..., 0], S[1][..., 0], S[2][..., 0])
    phi = _readback_phi10(_convolve(setup, grid, b), *S)
    phid = _dipole_phi(setup, mu, pscale, S, b)
    smu = mu * pscale[None, :]
    e = e + 0.5 * torch.sum(charges * phi[:, 0]) + torch.sum(smu * phi[:, 1:4]) \
        + 0.5 * torch.sum(smu * phid[:, 1:4])

    # self terms and the polarization cost
    e = e - (alpha / _SQRT_PI) * torch.sum(charges * charges) \
        - 0.5 * (4.0 / 3.0) * alpha ** 3 / _SQRT_PI * torch.sum(mu * mu)
    pol = torch.where(alpha_pol > 0, 1.0 / torch.where(alpha_pol > 0, alpha_pol, 1.0), 0.0)
    e = e + 0.5 * torch.sum(pol[:, None] * mu * mu)
    return units.ELECTRIC * e
