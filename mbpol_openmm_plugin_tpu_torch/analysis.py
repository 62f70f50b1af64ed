"""Trajectory analysis helpers: RDF, VACF/VDOS, dipole series, IR spectrum
(port of mbpol_openmm_plugin_tpu/analysis.py).

The reference delegates analysis to external tools (trajectories go out
through PDB/NetCDF reporters); these helpers cover the standard water
observables directly on position/velocity arrays as produced by the MD
drivers (md/simulation.py checkpoints, app reporters). Pure numpy over the
port's System - analysis is host-side post-processing, not a hot path -
except `dipole_series`, which evaluates the system moments on the
potential's device.
"""
from __future__ import annotations

import numpy as np

from mbpol_openmm_plugin_tpu_torch.models import electrostatics as E
from mbpol_openmm_plugin_tpu_torch.system import System
from mbpol_openmm_plugin_tpu_torch.utils.units import BOLTZMANN_KJ_MOL_K as _KB_KJ_MOL_K


def radial_distribution(system: System, frames, r_max=None, n_bins=200,
                        species='OO'):
    """g(r) between water sites over trajectory frames.

    frames: [n_frames, natoms, 3] positions (nm). Periodic systems use
    minimum-image distances; r_max defaults to box/2 (periodic) or the
    largest pair distance found (cluster).
    species: 'OO', 'OH', or 'HH'.
    Returns (r_centers [n_bins], g [n_bins]).
    """
    frames = np.asarray(frames)
    if frames.ndim == 2:
        frames = frames[None]
    sel = {'O': system.o_index,
           'H': np.concatenate([system.h1_index, system.h2_index])}
    a_idx, b_idx = sel[species[0]], sel[species[1]]
    same = species[0] == species[1]

    box = None if system.box is None else np.asarray(system.box)
    if r_max is None:
        r_max = (0.5 * float(box.min()) if box is not None
                 else float(np.max(np.linalg.norm(
                     frames[0][a_idx][:, None] - frames[0][b_idx][None],
                     axis=-1))))
    edges = np.linspace(0.0, r_max, n_bins + 1)
    hist = np.zeros(n_bins)

    for f in frames:
        d = f[a_idx][:, None, :] - f[b_idx][None, :, :]
        if box is not None:
            d -= np.round(d / box) * box
        r = np.linalg.norm(d, axis=-1)
        if same:
            iu = np.triu_indices(len(a_idx), k=1)
            r = r[iu]
        else:
            r = r.ravel()
        h, _ = np.histogram(r, bins=edges)
        hist += h

    centers = 0.5 * (edges[1:] + edges[:-1])
    shell_vol = 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    n_pairs = (len(a_idx) * (len(a_idx) - 1) // 2 if same
               else len(a_idx) * len(b_idx))
    if box is not None:
        vol = float(np.prod(box))
        ideal = n_pairs / vol * shell_vol
    else:
        # cluster: normalize to the mean pair density inside r_max
        ideal = n_pairs * shell_vol / (4.0 / 3.0 * np.pi * r_max ** 3)
    g = hist / (len(frames) * np.maximum(ideal, 1e-300))
    return centers, g


def _acf(series, max_lag):
    """Unbiased autocorrelation of a [n, k] series summed over components
    (zero-padded Wiener-Khinchin). Returns [max_lag]."""
    n = series.shape[0]
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    F = np.fft.rfft(series, n=nfft, axis=0)
    acf = np.fft.irfft((F * F.conj()).real, n=nfft, axis=0)[:max_lag]
    return acf.sum(axis=1) / (n - np.arange(max_lag))


def _spectrum(acf, dt):
    """Half-Hann-windowed cosine-transform magnitude of an ACF.
    Returns (freq_invcm, spectrum); dt in ps."""
    w = np.hanning(2 * len(acf))[len(acf):]
    spec = np.abs(np.fft.rfft(acf * w))
    freq_thz = np.fft.rfftfreq(len(acf), d=dt)        # 1/ps = THz
    return freq_thz / 0.0299792458, spec               # THz -> cm^-1


def velocity_autocorrelation(system: System, velocities, max_lag=None,
                             species='all'):
    """Normalized, mass-weighted VACF C(t)/C(0) over a velocity trajectory
    [n_frames, natoms, 3] (nm/ps). species: 'all' (real atoms), 'O', 'H'."""
    v = np.asarray(velocities)
    m = np.asarray(system.masses)
    if species == 'all':
        idx = np.where(m > 0)[0]
    elif species == 'O':
        idx = np.asarray(system.o_index)
    elif species == 'H':
        idx = np.concatenate([system.h1_index, system.h2_index])
    else:
        raise ValueError(species)
    v = v[:, idx, :] * np.sqrt(m[idx])[None, :, None]
    n = v.shape[0]
    acf = _acf(v.reshape(n, -1), max_lag or n // 2)
    return acf / acf[0]


def vibrational_density_of_states(system: System, velocities, dt,
                                  max_lag=None, species='all'):
    """VDOS: cosine transform of the VACF. Returns (freq_invcm, vdos)
    with frequencies in cm^-1 (dt in ps)."""
    acf = velocity_autocorrelation(system, velocities, max_lag=max_lag,
                                   species=species)
    return _spectrum(acf, dt)


def dipole_series(potential, frames):
    """Total system dipole (fixed charges + induced) per frame in Debye,
    via models.electrostatics.system_moments (the reference's
    getSystemElectrostaticsMoments convention: cluster SCF) on the
    potential's device. Returns [n_frames, 3]. Host loop - intended for
    reporting cadences, not per-step hot paths."""
    import torch

    masses = np.asarray(potential.system.masses)
    out = []
    with torch.no_grad():
        for f in np.asarray(frames):
            mom = E.system_moments(potential.elec_params, potential.as_positions(f), masses)
            out.append(mom[1:4].cpu().numpy())
    return np.asarray(out)


def unwrap_trajectory(frames, box):
    """Undo periodic wrapping of a trajectory so displacements accumulate.

    frames: [n_frames, natoms, 3] (nm), box: [3] (nm). Assumes no atom
    moves more than box/2 between consecutive frames (true at any sane
    reporting cadence). Returns the continuous trajectory.
    """
    frames = np.asarray(frames, dtype=np.float64)
    box = np.asarray(box, dtype=np.float64)
    d = np.diff(frames, axis=0)
    d -= np.round(d / box) * box
    return np.concatenate([frames[:1], frames[:1] + np.cumsum(d, axis=0)])


def _msd_fft(r):
    """Einstein MSD of trajectories r [n_frames, k, 3], averaged over the
    k particles, via the S1 - 2*S2 FFT decomposition (Calandrini et al.,
    nMoldyn): S2 is the position ACF, S1 comes from cumulative sums of
    |r|^2. O(n log n) per particle. Returns [n_frames]."""
    n, k = r.shape[0], r.shape[1]
    s2 = _acf(r.reshape(n, -1), n)                     # sum over k and xyz
    q = np.sum(r * r, axis=(1, 2))                     # [n]
    # S1(tau) = sum_{t<n-tau} (q(t) + q(t+tau)) / (n - tau)
    csum = np.cumsum(q)
    total = csum[-1]
    tau = np.arange(n)
    head = np.concatenate([[0.0], csum[:-1]])          # sum of q[0:tau]
    tail = np.concatenate([[0.0], np.cumsum(q[::-1])[:-1]])   # sum of q[n-tau:]
    s1 = (2.0 * total - head - tail) / (n - tau)
    return (s1 - 2.0 * s2) / k


def mean_squared_displacement(system: System, frames, dt, species='com',
                              box=None, unwrap=True, remove_system_com=True):
    """MSD(t) over a trajectory, for self-diffusion analysis.

    frames: [n_frames, natoms, 3] positions (nm); dt: frame spacing (ps).
    species: 'com' (molecular center of mass - the standard choice for
    water self-diffusion, isotope-mass aware), 'O', 'H', or 'all' (real
    atoms). Periodic trajectories are unwrapped first (box defaults to
    system.box); pass unwrap=False for already-continuous positions.

    Returns (t [n//2] ps, msd [n//2] nm^2) - lags restricted to half the
    trajectory where the time-origin average is statistically meaningful.
    """
    frames = np.asarray(frames, dtype=np.float64)
    if unwrap:
        b = box if box is not None else system.box
        if b is not None and np.all(np.asarray(b) > 0):
            frames = unwrap_trajectory(frames, np.asarray(b))
    r = _species_select(system, frames, species)
    if remove_system_com:
        # Subtract the SYSTEM center-of-mass trajectory: any residual net
        # momentum (e.g. from a thermostatted stage's last kick, or f32
        # force rounding over long NVE runs) adds a ballistic t^2 term to
        # every particle's MSD and inflates D_self - measured round 5 as
        # a 3x overestimate in the bulk-validation production run. This
        # is the standard convention for self-diffusion analysis.
        m = np.asarray(system.masses, np.float64)
        act = m > 0
        com = (np.einsum('fnd,n->fd', frames[:, act], m[act])
               / m[act].sum())
        r = r - com[:, None, :]
    n = frames.shape[0]
    msd = _msd_fft(r)[: n // 2]
    return np.arange(n // 2) * dt, msd


def _species_select(system: System, arr, species):
    """[n_frames, natoms, 3] -> [n_frames, k, 3] per-species selection.
    'com' is the mass-weighted molecular average (valid for positions AND
    velocities - the COM velocity is the same weighted mean)."""
    m = np.asarray(system.masses)
    if species == 'com':
        o, h1, h2 = (np.asarray(system.o_index), np.asarray(system.h1_index),
                     np.asarray(system.h2_index))
        w = np.stack([m[o], m[h1], m[h2]])             # [3, nmol]
        return (w[0, None, :, None] * arr[:, o] +
                w[1, None, :, None] * arr[:, h1] +
                w[2, None, :, None] * arr[:, h2]) / w.sum(0)[None, :, None]
    if species == 'O':
        return arr[:, np.asarray(system.o_index)]
    if species == 'H':
        return arr[:, np.concatenate([system.h1_index, system.h2_index])]
    if species == 'all':
        return arr[:, m > 0]
    raise ValueError(species)


def diffusion_coefficient_gk(system: System, velocities, dt, species='com',
                             max_lag=None):
    """Green-Kubo self-diffusion: the running integral
    D(t) = (1/3) int_0^t <v(0).v(s)> ds of the (unnormalized, per-particle)
    velocity autocorrelation, averaged over molecules and time origins.
    Cross-checks the Einstein-MSD route (`diffusion_coefficient`); both
    converge to the same D for a long enough trajectory.

    velocities: [n_frames, natoms, 3] (nm/ps); dt: frame spacing (ps) -
    must resolve the VACF decay (use the MD step cadence, not a sparse
    reporting cadence). Returns (t [max_lag] ps, D_running [max_lag]
    nm^2/ps); read D off the plateau a few VACF relaxation times in
    (for water, average D_running over t ~ 1-5 ps) - the deep tail of the
    running integral random-walks as ACF noise accumulates.
    """
    v = _species_select(system, np.asarray(velocities, np.float64), species)
    n, k = v.shape[0], v.shape[1]
    acf = _acf(v.reshape(n, -1), max_lag or n // 2) / k   # <v(0).v(t)> [3dim]
    # trapezoid cumulative integral, D(0) = 0
    run = np.concatenate([[0.0], np.cumsum(0.5 * (acf[1:] + acf[:-1]) * dt)])
    return np.arange(len(acf)) * dt, run / 3.0


def diffusion_coefficient(t, msd, fit_window=(0.2, 0.8)):
    """Self-diffusion coefficient from the Einstein relation
    MSD = 6 D t + c, least-squares fit over the fit_window fraction of
    the lag range (defaults skip the ballistic/caging onset and the
    noisy tail). t in ps, msd in nm^2; returns D in nm^2/ps
    (1 nm^2/ps = 1e-2 cm^2/s)."""
    t = np.asarray(t, np.float64)
    msd = np.asarray(msd, np.float64)
    i0 = int(len(t) * fit_window[0])
    i1 = min(max(int(len(t) * fit_window[1]), i0 + 2), len(t))
    if i1 - i0 < 2 or t[i0] == t[i1 - 1]:
        raise ValueError(f'need >= 2 distinct lag times in the fit window; '
                         f'got {i1 - i0} from a {len(t)}-lag MSD - '
                         f'use a longer trajectory')
    slope, _ = np.polyfit(t[i0:i1], msd[i0:i1], 1)
    return slope / 6.0


def static_dielectric(dipoles, volume, temperature):
    """Static dielectric constant from total-dipole fluctuations under
    conducting (tin-foil) boundaries - the correct formula for Ewald/PME
    trajectories (Neumann 1983): eps = 1 + (<M^2>-<M>^2) / (3 eps0 V kB T).

    dipoles: [n_frames, 3] total dipole in Debye (`dipole_series` output);
    volume: box volume in nm^3 (scalar, or [3] box edge lengths);
    temperature: K. Returns the dimensionless eps.
    """
    mu = np.asarray(dipoles, dtype=np.float64)
    v = np.asarray(volume, dtype=np.float64)
    v_nm3 = float(np.prod(v)) if v.ndim else float(v)
    var_d2 = float(np.sum(np.var(mu, axis=0)))         # Debye^2
    debye_cm = 3.335640952e-30                          # C*m per Debye
    eps0 = 8.8541878128e-12                             # F/m
    kb = 1.380649e-23                                   # J/K
    return 1.0 + (var_d2 * debye_cm ** 2 /
                  (3.0 * eps0 * v_nm3 * 1e-27 * kb * float(temperature)))


def infrared_spectrum(dipoles, dt, max_lag=None):
    """Classical IR lineshape from a total-dipole time series.

    dipoles: [n_frames, 3] (e.g. from `dipole_series`; units cancel in the
    relative lineshape). dt: frame spacing in ps. The intensity is the
    spectrum of the dipole-DERIVATIVE autocorrelation (Wiener-Khinchin) -
    the standard classical/ring-polymer IR estimate I(w) ~ w^2 C_mumu(w),
    computed in the derivative form because a post-hoc w^2 prefactor
    amplifies windowing leakage near Nyquist while the mu-dot ACF keeps
    leakage relative to the true lines.

    Returns (freq_invcm, intensity).
    """
    mu = np.asarray(dipoles, dtype=np.float64)
    mudot = (mu[2:] - mu[:-2]) / (2.0 * dt)       # central difference
    acf = _acf(mudot, max_lag or mudot.shape[0] // 2)
    return _spectrum(acf, dt)


def _logsumexp(a, axis):
    m = np.max(a, axis=axis, keepdims=True)
    return np.squeeze(
        m + np.log(np.sum(np.exp(a - m), axis=axis, keepdims=True)),
        axis=axis)


def mbar_free_energies(energies, temperatures, tol=1e-10, max_iter=20000):
    """MBAR (Shirts & Chodera, J. Chem. Phys. 129, 124105 (2008)) for a
    temperature ladder: the dimensionless free energies f_k of each
    ladder state, from per-slot potential-energy samples. The natural
    post-processing companion of md/remd.py - together with
    `mbar_reweight` it turns a parallel-tempering run into observables
    at ANY temperature in the ladder's range, not just the simulated
    ones. (The reference delegates all analysis to external tools.)

    energies: [K, N] kJ/mol - N samples from each of the K ladder slots
    (e.g. `REMDSimulation.run()['potential_energy'].T`). In a
    temperature ladder the reduced potential of state k at configuration
    x is u_k(x) = beta_k U(x), so only the scalar U samples are needed.
    temperatures: [K] kelvin, matching the slot order.

    Returns f [K] (dimensionless, f[0] = 0) solving the self-consistent
    MBAR equations by direct iteration with log-sum-exp stabilization.
    """
    U = np.asarray(energies, np.float64)
    K, N = U.shape
    T = np.asarray(temperatures, np.float64)
    if T.shape != (K,):
        raise ValueError(f'temperatures shape {T.shape} != ({K},)')
    betas = 1.0 / (_KB_KJ_MOL_K * T)
    u_pool = U.reshape(-1)                       # pooled samples [K*N]
    u_kn = betas[:, None] * u_pool[None, :]      # [K, K*N]
    logN = np.log(N)
    f = np.zeros(K)
    for _ in range(max_iter):
        log_denom = _logsumexp(logN + f[:, None] - u_kn, axis=0)
        f_new = -_logsumexp(-u_kn - log_denom[None, :], axis=1)
        f_new = f_new - f_new[0]
        done = np.max(np.abs(f_new - f)) < tol
        f = f_new
        if done:
            return f
    raise RuntimeError(f'MBAR did not converge in {max_iter} iterations '
                       f'(last f = {f})')


def mbar_reweight(energies, temperatures, target_temperature, f=None,
                  observable=None):
    """Reweight pooled ladder samples to an arbitrary target temperature.

    energies: [K, N] kJ/mol as in `mbar_free_energies`; observable:
    optional per-sample values, [K, N] or [K, N, ...] in the same slot
    order. f: precomputed `mbar_free_energies` output (computed here if
    omitted).

    Returns a dict with `weights` [K*N] (normalized MBAR weights of the
    pooled samples at the target temperature), `n_eff` (Kish effective
    sample size 1/sum(w^2)), and - when `observable` is given - `mean`,
    its weighted expectation at the target temperature.
    """
    U = np.asarray(energies, np.float64)
    K, N = U.shape
    T = np.asarray(temperatures, np.float64)
    if f is None:
        f = mbar_free_energies(U, T)
    betas = 1.0 / (_KB_KJ_MOL_K * T)
    beta_t = 1.0 / (_KB_KJ_MOL_K * float(target_temperature))
    u_pool = U.reshape(-1)
    u_kn = betas[:, None] * u_pool[None, :]
    log_denom = _logsumexp(np.log(N) + np.asarray(f)[:, None] - u_kn, axis=0)
    log_w = -beta_t * u_pool - log_denom
    log_w -= _logsumexp(log_w, axis=0)
    w = np.exp(log_w)
    out = dict(weights=w, n_eff=1.0 / np.sum(w * w))
    if observable is not None:
        a = np.asarray(observable, np.float64)
        if a.shape[:2] != (K, N):
            raise ValueError(f'observable shape {a.shape} does not start '
                             f'with ({K}, {N})')
        a = a.reshape(K * N, *a.shape[2:])
        out['mean'] = np.tensordot(w, a, axes=(0, 0))
    return out


def static_structure_factor(system: System, frames, q_max=30.0,
                            n_bins=60, species='O'):
    """Static structure factor S(q) of the selected sites, spherically
    averaged over the reciprocal lattice of the periodic box:
    S(q) = <|sum_j exp(i q.r_j)|^2> / N at the allowed q = 2 pi n / L,
    binned by |q|. The X-ray/neutron-facing complement of g(r), computed
    directly (no Fourier transform of g(r), so no truncation ripples).

    frames: [n_frames, natoms, 3] nm (periodic systems only).
    q_max: 1/nm. species: 'O', 'H', or 'all' (all real sites).
    Returns (q_centers [<=n_bins], S [<=n_bins]) - bins with no allowed
    lattice vector are dropped.
    """
    frames = np.asarray(frames)
    if frames.ndim == 2:
        frames = frames[None]
    if system.box is None:
        raise ValueError('structure factor needs a periodic box')
    box = np.asarray(system.box, np.float64)
    if species == 'O':
        idx = system.o_index
    elif species == 'H':
        idx = np.concatenate([system.h1_index, system.h2_index])
    elif species == 'all':
        idx = np.where(np.asarray(system.masses) > 0)[0]
    else:
        raise ValueError(f'unknown species {species!r}')

    # allowed reciprocal-lattice vectors with 0 < |q| <= q_max, one
    # hemisphere (S(-q) = S(q) for real densities)
    nmax = np.floor(q_max * box / (2.0 * np.pi)).astype(int)
    gx, gy, gz = np.meshgrid(*(np.arange(-n, n + 1) for n in nmax),
                             indexing='ij')
    n_vec = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    hemi = ((n_vec[:, 0] > 0) | ((n_vec[:, 0] == 0) & (n_vec[:, 1] > 0)) |
            ((n_vec[:, 0] == 0) & (n_vec[:, 1] == 0) & (n_vec[:, 2] > 0)))
    q_vec = 2.0 * np.pi * n_vec[hemi] / box
    q_abs = np.linalg.norm(q_vec, axis=1)
    keep = q_abs <= q_max
    q_vec, q_abs = q_vec[keep], q_abs[keep]

    s_q = np.zeros(len(q_vec))
    for f in frames:
        phase = f[idx] @ q_vec.T                    # [nsel, nq]
        rho_re = np.cos(phase).sum(axis=0)
        rho_im = np.sin(phase).sum(axis=0)
        s_q += (rho_re ** 2 + rho_im ** 2) / len(idx)
    s_q /= len(frames)

    edges = np.linspace(0.0, q_max, n_bins + 1)
    which = np.digitize(q_abs, edges) - 1
    counts = np.bincount(which, minlength=n_bins)[:n_bins]
    sums = np.bincount(which, weights=s_q, minlength=n_bins)[:n_bins]
    q_sums = np.bincount(which, weights=q_abs, minlength=n_bins)[:n_bins]
    nz = counts > 0
    return q_sums[nz] / counts[nz], sums[nz] / counts[nz]


def hydrogen_bonds(system: System, frames, r_oo_max=0.35,
                   angle_max_deg=30.0):
    """Per-frame hydrogen-bond count with the standard geometric
    criterion (Luzar & Chandler, Nature 379, 55 (1996)): donor-acceptor
    O..O distance < r_oo_max (nm) AND the H-O_d-O_a angle < angle_max_deg.
    Periodic systems use minimum-image separations.

    frames: [n_frames, natoms, 3] nm. Returns [n_frames] int bond counts
    (each donated H counted once). Every bond is shared by a donor and
    an acceptor, so the per-molecule average is 2*count/n_molecules
    (~3.5 in bulk liquid water).
    """
    frames = np.asarray(frames)
    if frames.ndim == 2:
        frames = frames[None]
    box = None if system.box is None else np.asarray(system.box)
    o_idx = np.asarray(system.o_index)
    cos_max = np.cos(np.deg2rad(angle_max_deg))
    counts = np.zeros(len(frames), np.int64)

    def mi(d):
        return d - np.round(d / box) * box if box is not None else d

    for fi, f in enumerate(frames):
        o = f[o_idx]
        d_oo = mi(o[None] - o[:, None])     # [donor i, acceptor k, 3]
        r_oo = np.linalg.norm(d_oo, axis=-1)
        np.fill_diagonal(r_oo, np.inf)
        close = r_oo < r_oo_max
        n = 0
        for h_idx in (system.h1_index, system.h2_index):
            d_oh = mi(f[h_idx] - f[o_idx])              # donor O -> its H
            u_oh = d_oh / np.linalg.norm(d_oh, axis=-1, keepdims=True)
            u_oo = d_oo / np.where(np.isfinite(r_oo), r_oo, 1.0)[..., None]
            cos_a = np.einsum('ij,ikj->ik', u_oh, u_oo)  # donor i, acceptor k
            n += int(np.sum(close & (cos_a > cos_max)))
        counts[fi] = n
    return counts


def tetrahedral_order(system: System, frames):
    """Per-frame mean orientational tetrahedral order parameter
    (Errington & Debenedetti, Nature 409, 318 (2001)):
    q_i = 1 - 3/8 sum_{j<k in 4 nearest O} (cos psi_jik + 1/3)^2,
    q = 1 for a perfect tetrahedron, <q> = 0 for an ideal gas.

    frames: [n_frames, natoms, 3] nm. Returns [n_frames] means over
    molecules. Needs >= 5 waters.
    """
    frames = np.asarray(frames)
    if frames.ndim == 2:
        frames = frames[None]
    box = None if system.box is None else np.asarray(system.box)
    o_idx = np.asarray(system.o_index)
    if len(o_idx) < 5:
        raise ValueError('tetrahedral order needs >= 5 waters')
    out = np.zeros(len(frames))
    for fi, f in enumerate(frames):
        o = f[o_idx]
        d = o[:, None] - o[None]
        if box is not None:
            d -= np.round(d / box) * box
        r = np.linalg.norm(d, axis=-1)
        np.fill_diagonal(r, np.inf)
        nn = np.argsort(r, axis=1)[:, :4]               # 4 nearest
        vec = -d[np.arange(len(o))[:, None], nn]        # center -> neighbor
        u = vec / np.linalg.norm(vec, axis=-1, keepdims=True)
        cosjk = np.einsum('iad,ibd->iab', u, u)
        jj, kk = np.triu_indices(4, 1)
        q = 1.0 - 0.375 * np.sum((cosjk[:, jj, kk] + 1.0 / 3.0) ** 2,
                                 axis=1)
        out[fi] = q.mean()
    return out


def mbar_heat_capacity(energies, temperatures, target_temperatures=None,
                       f=None):
    """Configurational heat-capacity curve from ladder samples:
    Cv(T) = Var_T(U) / (kB T^2), with the variance MBAR-reweighted to
    each target temperature (fluctuation formula; add the kinetic
    3 N kB / 2 for the full classical Cv).

    energies/temperatures as in `mbar_free_energies`;
    target_temperatures: [M] kelvin (default: the ladder itself).
    Returns (target_temperatures [M], cv [M] kJ/mol/K).
    """
    U = np.asarray(energies, np.float64)
    T = np.asarray(temperatures, np.float64)
    ts = (T if target_temperatures is None
          else np.asarray(target_temperatures, np.float64))
    if f is None:
        f = mbar_free_energies(U, T)
    cv = np.empty(len(ts))
    for i, t in enumerate(ts):
        out = mbar_reweight(U, T, float(t), f=f,
                            observable=np.stack([U, U * U], axis=-1))
        u1, u2 = out['mean']
        cv[i] = (u2 - u1 * u1) / (_KB_KJ_MOL_K * t * t)
    return ts, cv
