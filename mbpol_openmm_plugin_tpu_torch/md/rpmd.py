"""Thermostatted ring-polymer MD, PIMD (port of mbpol_openmm_plugin_tpu/md/rpmd.py).

PILE thermostat (Ceriotti, Parrinello, Markland, Manolopoulos, J. Chem.
Phys. 133, 124104 (2010)) in the BAOAB splitting: half force kick, half
exact free ring-polymer evolution in normal modes, the OU step on the mode
momenta (gamma_k = 2 omega_k; the centroid at 1/tau0, or 0), half free
evolution, half kick. The normal-mode transforms are [n, n] products on the
bead axis. Ring-polymer contraction (Markland & Manolopoulos, J. Chem.
Phys. 129, 024105 (2008)) evaluates the intermolecular terms on n_c
contracted beads and the one-body term on all n; the NPT move scales each
molecule's ring-polymer centroid with the box.

Conventions as the JAX package: H_n = sum_i p_i^2/2m + sum_i 1/2 m omega_n^2
(q_i - q_{i+1})^2 + sum_i V(q_i), sampled at beta_n = beta/n, omega_n =
n kT/hbar; nm, ps, amu, kJ/mol. The M sites carry zero mass: their momenta
stay zero and the potential places them.

Where the JAX package vmaps the potential over the bead axis, the port
evaluates the beads one after another (each with the bits of a single
evaluation), and on a card `PIMDSimulation` replays each ring-polymer step
as one CUDA graph (md/step_graph.py), so a step costs about the device time
of its evaluations. The random draws (the spread of `initial_state`, the
O step's normals [n, natoms, 3], the barostat's two uniforms) are
arguments, drawn before their step from one torch.Generator.

`term_subset` and `mbpol_intra_inter_split` also serve r-RESPA
(md/simulation.py): the one-body term on the inner rung, the rest outside.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch.md import integrators as I
from mbpol_openmm_plugin_tpu_torch.md.step_graph import LIST_KEYS, StepGraph
from mbpol_openmm_plugin_tpu_torch.models import electrostatics as elec
from mbpol_openmm_plugin_tpu_torch.models.one_body import one_body_energy
from mbpol_openmm_plugin_tpu_torch.models.potential import (MBPol, inherit_capacities,
                                                            with_scf_method)
from mbpol_openmm_plugin_tpu_torch.parallel.mesh import Mesh, shard_of, to_device
from mbpol_openmm_plugin_tpu_torch.system import (System, compute_virtual_sites,
                                                  make_molecules_whole, water_positions)
from mbpol_openmm_plugin_tpu_torch.utils import units
from mbpol_openmm_plugin_tpu_torch.utils.consts import device_const

# hbar * N_A in kJ/mol * ps (CODATA hbar = 1.054571817e-34 J s)
HBAR_KJMOL_PS = 1.054571817e-34 * 6.02214076e23 / 1000.0 / 1e-12


def normal_mode_matrix(n_beads):
    """Orthonormal cyclic normal-mode transform C [n, n]: P_k = C @ p. Row 0
    is the centroid, rows 1..n/2 cosine modes (the Nyquist row for even n),
    the rest sine modes."""
    n = n_beads
    j = np.arange(n)
    C = np.zeros((n, n))
    C[0] = np.sqrt(1.0 / n)
    for k in range(1, n // 2 + 1):
        if 2 * k == n:
            C[k] = np.sqrt(1.0 / n) * (-1.0) ** j
        else:
            C[k] = np.sqrt(2.0 / n) * np.cos(2.0 * np.pi * k * j / n)
    for k in range(n // 2 + 1, n):
        C[k] = np.sqrt(2.0 / n) * np.sin(2.0 * np.pi * (n - k) * j / n)
    return C


def normal_mode_frequencies(n_beads, temperature_k):
    """omega_k = 2 omega_n sin(pi k~ / n) [1/ps] in the rows of
    normal_mode_matrix; omega_0 = 0 (centroid)."""
    kT = units.BOLTZMANN_KJ_MOL_K * temperature_k
    omega_n = n_beads * kT / HBAR_KJMOL_PS
    k = np.arange(n_beads)
    return 2.0 * omega_n * np.sin(np.pi * np.minimum(k, n_beads - k) / n_beads)


def contraction_matrix(n_beads, n_contracted):
    """Ring-polymer contraction transform T [n_c, n]: the n_c lowest modes
    resampled onto an n_c-bead ring, T = sqrt(n_c/n) C_c^T S C. The identity
    at n_c == n; otherwise n_c must be odd (no Nyquist splitting)."""
    n, nc = int(n_beads), int(n_contracted)
    if nc == n:
        return np.eye(n)
    if not (1 <= nc < n) or nc % 2 == 0:
        raise ValueError(f'n_contracted={nc} must be odd and in [1, n_beads={n}]')
    C = normal_mode_matrix(n)
    Cc = normal_mode_matrix(nc)
    rows_c, rows_full = [0], [0]
    for k in range(1, nc // 2 + 1):
        rows_c += [k, nc - k]
        rows_full += [k, n - k]
    return np.sqrt(nc / n) * (Cc[rows_c].T @ C[rows_full])


def _const(a, like):
    return device_const(a, dtype=like.dtype, device=like.device)


def _beads(a, b):
    """a [x, y] (a host table) applied on the bead axis of b [y, ...]."""
    return torch.tensordot(_const(a, b), b, dims=1)


def _stack(results):
    """(E [k], F [k, natoms, 3]) from k (E, F) pairs."""
    return torch.stack([r[0] for r in results]), torch.stack([r[1] for r in results])


def contracted_energy_forces(ef_inter, ef_intra, n_beads, n_contracted):
    """ef(q [n, natoms, 3], *per_bead) -> (e [n], f [n, natoms, 3]) with the
    intermolecular ef_inter(p, *args) -> (E, F) on the n_c contracted
    beads, E_inter = (n/n_c) sum_a V(q'_a), F += (n/n_c) T^T F', and
    ef_intra(p) -> (E, F) on all n beads. args: the contracted bead's items
    of per_bead, sequences of n_c (PIMDSimulation passes each bead's SCF
    start and lists). The intermolecular energy is spread evenly over the
    beads, so sum(e) is the RPC potential."""
    n, nc = int(n_beads), int(n_contracted)
    T = contraction_matrix(n, nc)
    scale = n / nc

    def ef(q, *per_bead):
        e_c, f_c = _stack([ef_inter(p, *a) for p, *a in zip(_beads(T, q), *per_bead)])
        e_i, f_i = _stack([ef_intra(p) for p in q])
        return e_i + (scale / n) * torch.sum(e_c), f_i + scale * _beads(T.T, f_c)

    return ef


def _real(system, like):
    return device_const((np.asarray(system.masses) > 0)[None, :, None], dtype=torch.bool,
                        device=like.device)


def spring_energy(system: System, positions, temperature_k):
    """Ring-polymer spring energy sum_i 1/2 m omega_n^2 |q_i - q_{i+1}|^2
    (cyclic, kJ/mol). positions: [n_beads, natoms, 3]."""
    n = positions.shape[0]
    omega_n = n * units.BOLTZMANN_KJ_MOL_K * temperature_k / HBAR_KJMOL_PS
    m = _const(np.asarray(system.masses)[None, :, None], positions)
    d = positions - torch.roll(positions, -1, dims=0)
    return 0.5 * omega_n ** 2 * torch.sum(m * d * d)


def kinetic_energy_virial(system: System, positions, forces, temperature_k):
    """Centroid-virial quantum kinetic energy (kJ/mol):
    3N/(2 beta) - 1/(2n) sum_i (q_i - q_c) . F_i."""
    n = positions.shape[0]
    kT = units.BOLTZMANN_KJ_MOL_K * temperature_k
    n_real = int(np.sum(np.asarray(system.masses) > 0))
    qc = torch.mean(positions, dim=0, keepdim=True)
    return 1.5 * n_real * kT - 0.5 / n * torch.sum((positions - qc) * forces)


def kinetic_energy_primitive(system: System, positions, temperature_k):
    """Primitive quantum kinetic energy (kJ/mol): 3 N n/(2 beta) - E_spring."""
    n = positions.shape[0]
    kT = units.BOLTZMANN_KJ_MOL_K * temperature_k
    n_real = int(np.sum(np.asarray(system.masses) > 0))
    return 1.5 * n_real * n * kT - spring_energy(system, positions, temperature_k)


def ring_polymer_hamiltonian(system: System, state: I.MDState, temperature_k):
    """The conserved quantity of the gamma = 0 (NVE) RPMD flow:
    sum_beads (classical KE + V) + E_spring."""
    v = state.velocities
    m = _const(np.asarray(system.masses)[None, :, None], v)
    return (0.5 * torch.sum(m * v * v) + spring_energy(system, state.positions, temperature_k)
            + torch.sum(state.potential_energy))


def initial_state(system: System, positions, n_beads, temperature_k, generator=None, box=None,
                  spread=0.0, normals=None):
    """Bead-leading MDState: every bead at `positions` (plus, with spread,
    spread x standard normals on the real atoms: `normals` [n, natoms, 3],
    else drawn from `generator`), zero velocities, forces and energies.

    box: bookkeeping only and must equal system.box (the evaluations run at
    the state's box, which a barostat moves; a different value here would
    evaluate other periodic physics)."""
    if box is not None:
        if system.box is None:
            raise ValueError('box given but the System is non-periodic; pass box at System '
                             'construction')
        if not np.allclose(np.asarray(box), np.asarray(system.box)):
            raise ValueError(f'box {box} != system.box {system.box}; RPMD evaluates at the '
                             'system box')
    pos = positions[None].expand((int(n_beads),) + tuple(positions.shape)).clone()
    if spread > 0.0:
        if normals is None:
            normals = torch.randn(tuple(pos.shape), generator=generator, dtype=pos.dtype,
                                  device=pos.device)
        pos = pos + torch.where(_real(system, pos), spread * normals, 0.0)
    return I.MDState(positions=pos, velocities=torch.zeros_like(pos),
                     forces=torch.zeros_like(pos),
                     potential_energy=torch.zeros((int(n_beads),), dtype=pos.dtype,
                                                  device=pos.device),
                     box=None if system.box is None else np.array(system.box, np.float64),
                     step=0)


def make_rpmd_step(system: System, energy_forces_fn, n_beads, dt, temperature_k, tau0=None,
                   thermostat='pile', batched=False, with_aux=False, with_box=False):
    """`step(state, noise[, aux]) -> state` (or (state, aux')): one BAOAB
    ring-polymer step; noise: standard normals [n, natoms, 3] of the O step
    in mode space.

    energy_forces_fn: positions [natoms, 3] -> (E, F) of one bead, looped
    over the beads; with batched=True it maps [n, natoms, 3] -> ([n],
    [n, natoms, 3]) itself (contracted_energy_forces). with_aux (batched
    only): it takes and returns an opaque carry (q, aux) -> (e, f, aux'),
    e.g. the dipole history; with_box: the state's box is its last
    argument (the NPT path).
    tau0: the centroid's thermostat time constant (ps; None or 0: no
    centroid friction); thermostat 'pile' or 'none' (every gamma 0: the O
    step is the identity and ring_polymer_hamiltonian is conserved)."""
    n = int(n_beads)
    if thermostat not in ('pile', 'none'):
        raise ValueError(thermostat)
    if with_aux and not batched:
        raise ValueError('with_aux needs a batched energy_forces_fn')
    kT = units.BOLTZMANN_KJ_MOL_K * temperature_k
    C = normal_mode_matrix(n)
    omega = normal_mode_frequencies(n, temperature_k)
    if thermostat == 'none':
        gamma = np.zeros(n)
    else:
        gamma = 2.0 * omega
        gamma[0] = (1.0 / tau0) if tau0 else 0.0
    c1 = np.exp(-gamma * dt)
    c2 = np.sqrt(np.maximum(1.0 - c1 * c1, 0.0))
    th = omega * (0.5 * dt)
    col = (slice(None), None, None)
    cos_h = np.cos(th)[col]
    # sin(theta)/omega, with the omega -> 0 centroid limit dt/2
    sin_over_omega = np.where(omega > 0.0, np.sin(th) / np.where(omega > 0.0, omega, 1.0),
                              0.5 * dt)[col]
    msin = np.where(omega > 0.0, omega * np.sin(th), 0.0)[col]
    masses = np.asarray(system.masses)[None, :, None]
    inv = np.where(masses > 0, 1.0 / np.where(masses > 0, masses, 1.0), 0.0)
    sigma = np.sqrt(masses * n * kT)

    def step(state, noise, aux=None):
        like = state.positions
        m, inv_m, real = _const(masses, like), _const(inv, like), _real(system, like)
        cos, so, ms = _const(cos_h, like), _const(sin_over_omega, like), _const(msin, like)

        def a_half(P, Q):
            # the exact free ring polymer: a rotation in (P, m omega Q) per
            # mode; the massless M sites stay where they are
            return (torch.where(real, cos * P - m * ms * Q, P),
                    torch.where(real, so * inv_m * P + cos * Q, Q))

        p = state.velocities * m + 0.5 * dt * state.forces
        P, Q = a_half(_beads(C, p), _beads(C, state.positions))
        P = _const(c1[col], like) * P + torch.where(
            real, _const(c2[col], like) * _const(sigma, like) * noise, 0.0)
        P, Q = a_half(P, Q)
        p, q = _beads(C.T, P), _beads(C.T, Q)
        args = ((aux,) if with_aux else ()) + ((state.box,) if with_box else ())
        if batched:
            out = energy_forces_fn(q, *args)
        else:
            out = _stack([energy_forces_fn(qb, *args) for qb in q])
        e, f = out[0], out[1]
        new = dataclasses.replace(state, positions=q, velocities=(p + 0.5 * dt * f) * inv_m,
                                  forces=f, potential_energy=e, step=state.step + 1)
        return (new, out[2]) if with_aux else new

    return step


def rpmd_barostat_move(system: System, bead_energy_fn, state: I.MDState, temperature_k,
                       pressure_bar, uniforms, scale_nm3=None):
    """One MC volume move on the ring polymer: each molecule's beads shift
    rigidly with its ring-polymer centroid (mass-weighted over the atoms,
    averaged over the beads), so the intra-bead geometry and the springs
    are invariant and the weight is
        w = mean_b dU_b + P dV - N_mol kT ln(V'/V)
    (integrators.monte_carlo_barostat_move at one bead).

    bead_energy_fn(q [n, natoms, 3], box) -> (e [n], f [n, natoms, 3]), per
    bead in the step's convention (with contraction, intra_b + (n_c/n)...;
    the bead mean is the RPC potential either way); both sides of the
    weight come from it. uniforms: two draws in [0, 1), the volume change
    and the acceptance; scale_nm3: the move size (default 1% of the
    volume). An accepted move carries the trial's energies AND forces (the
    JAX function keeps the old positions' forces); a rejected one keeps its
    forces and takes the energies of the old positions. The decision reads
    the energies on the host once. Returns (state', accepted)."""
    from mbpol_openmm_plugin_tpu_torch.md.pressure import BAR_IN_KJ_MOL_NM3, _molecular_coms

    u_dv, u_acc = (float(u) for u in uniforms.tolist())
    kT = units.BOLTZMANN_KJ_MOL_K * temperature_k
    box = np.asarray(state.box, np.float64)
    vol = float(np.prod(box))
    if scale_nm3 is None:
        scale_nm3 = 0.01 * vol
    dv = (u_dv * 2.0 - 1.0) * scale_nm3
    new_vol = vol + dv
    s = (new_vol / vol) ** (1.0 / 3.0)
    q = state.positions
    centroid, _ = _molecular_coms(system, torch.mean(q, dim=0))
    mol = device_const(np.asarray(system.mol_index, np.int64), device=q.device)
    pos_new = q + (centroid * (s - 1.0))[mol][None]
    box_new = box * s
    e_new, f_new = bead_energy_fn(pos_new, box_new)
    e_old, _ = bead_energy_fn(q, box)
    nmol = int(np.asarray(system.mol_index).max()) + 1
    w = (float(torch.mean((e_new - e_old).double())) + pressure_bar * BAR_IN_KJ_MOL_NM3 * dv
         - nmol * kT * math.log(new_vol / vol))
    accept = w <= 0 or u_acc < math.exp(-w / kT)
    if accept:
        return dataclasses.replace(state, positions=pos_new, box=box_new, forces=f_new,
                                   potential_energy=e_new), True
    return dataclasses.replace(state, potential_energy=e_old), False


def term_subset(potential: MBPol, terms):
    """An MBPol over the same system, device, mesh and configuration with
    only `terms`, on the parent's tuned capacities (inherit_capacities)."""
    return inherit_capacities(potential, MBPol(
        potential.system, dataclasses.replace(potential.config, terms=tuple(terms)),
        device=potential.device, mesh=potential.mesh))


def mbpol_intra_inter_split(potential: MBPol):
    """(ef_intra, pot_inter): ef_intra(positions, box=None) -> (E, F) is the
    one-body Partridge-Schwenke term on whole molecules (zero when the
    parent has no one-body term); pot_inter is an MBPol over the parent's
    other terms with its capacities (the parent itself when it has no
    one-body term)."""
    sys_ = potential.system
    has_one_body = 'one_body' in potential.config.terms
    pot_inter = (term_subset(potential, [t for t in potential.config.terms if t != 'one_body'])
                 if has_one_body else potential)

    def ef_intra(p, box=None):
        if not has_one_body:
            return torch.zeros((), dtype=p.dtype, device=p.device), torch.zeros_like(p)
        with torch.enable_grad():
            q = p.detach().requires_grad_(True)
            # hydrogens imaged next to their O as in the full evaluation
            e = torch.sum(one_body_energy(water_positions(
                sys_, make_molecules_whole(sys_, q, box))))
            g, = torch.autograd.grad(e, q)
        return e.detach(), -g

    return ef_intra, pot_inter


def _evaluation(pot):
    """ef(p) -> (E, F) of a full evaluation of pot (its own start)."""
    def ef(p):
        e, f, _, _ = pot._energy_forces_impl(p)
        return e, f
    return ef


def make_rpmd_potential_step(potential: MBPol, n_beads, dt, temperature_k, tau0=None,
                             thermostat='pile'):
    """`step(state, noise)`: the RPMD step over an MBPol potential, each
    bead one full evaluation."""
    return make_rpmd_step(potential.system, _evaluation(potential), n_beads, dt, temperature_k,
                          tau0=tau0, thermostat=thermostat)


def make_rpmd_contracted_potential_step(potential: MBPol, n_beads, n_contracted, dt,
                                        temperature_k, tau0=None, thermostat='pile'):
    """`step(state, noise)` with ring-polymer contraction: the one-body term
    on all n beads, the other terms on n_contracted (odd, or n_beads)."""
    ef_intra, pot_inter = mbpol_intra_inter_split(potential)
    ef = contracted_energy_forces(_evaluation(pot_inter), ef_intra, n_beads, n_contracted)
    return make_rpmd_step(potential.system, ef, n_beads, dt, temperature_k, tau0=tau0,
                          thermostat=thermostat, batched=True)


def _bead_evaluations(pot: MBPol, n_beads, contraction, ef_intra, aspc_k, bead_pots=None):
    """PIMDSimulation's batched evaluation ef(q, aux, box) -> (e [n],
    f [n, natoms, 3], aux'). aux: the dipole payload 'mu' (None: converged
    cold evaluations), the per-evaluated-bead lists 'nl' (None: each
    evaluation builds its own) and the overflow flag 'ovf'; aux' also holds
    the evaluated beads' new dipoles, 'dipoles' [ne, natoms, 3] (None
    without the electrostatics term). With `contraction` n_c, pot (the
    intermolecular terms) runs on the n_c contracted beads and ef_intra on
    all n (contracted_energy_forces); aspc_k: the ASPC order of the
    payload's history (None: the payload is the last dipoles); bead_pots:
    each evaluated bead's copy of pot on its shard's device (None: pot for
    every bead), whose results come back to the beads' device. Built from
    the potential alone: a step function that held its driver would keep
    the driver, and its CUDA graph, in a reference cycle."""
    B = None if aspc_k is None else elec.aspc_predictor_coefficients(aspc_k)
    n_eval = int(contraction) if contraction else int(n_beads)

    def ef(q, aux, box):
        mu = aux['mu']
        if mu is None:
            starts = [None] * n_eval
        elif B is not None:
            starts = list(torch.einsum('h,ehnd->end', _const(B, mu), mu))
        else:
            starts = list(mu)
        nls = aux['nl'] if aux['nl'] is not None else [None] * n_eval
        pots = bead_pots if bead_pots is not None else [pot] * n_eval
        flags, dipoles = [], []

        def one(p, mu0, nl, bead_pot=pot):
            dev = bead_pot.device
            e, f, _, diag = bead_pot._energy_forces_impl(
                p.to(dev), to_device(mu0, dev), nlists=to_device(nl, dev), box=box)
            flags.extend(v.to(p.device) for k, v in diag.items() if k.endswith('_overflow'))
            dipoles.append(to_device(diag.get('induced_dipoles', mu0), p.device))
            return e.to(p.device), f.to(p.device)

        if contraction:
            e, f = contracted_energy_forces(one, lambda p: ef_intra(p, box), n_beads,
                                            contraction)(q, starts, nls)
        else:
            e, f = _stack([one(*a) for a in zip(q, starts, nls, pots)])
        ovf = aux['ovf']
        for v in flags:
            ovf = ovf | v
        d = None if dipoles[0] is None else torch.stack(dipoles)
        if mu is not None:
            mu = torch.cat([d[:, None], mu[:, :-1]], dim=1) if B is not None else d
        return e, f, dict(aux, mu=mu, ovf=ovf, dipoles=d)

    return ef


class PIMDSimulation:
    """PIMD driver over an MBPol potential, with the surface of the JAX
    package's (health checks at report boundaries, checkpoints, NPT,
    contraction, list reuse). Reported observables are the quantum
    estimators: the bead-mean potential <V>, the centroid-virial kinetic
    energy and their sum.

    Every ring-polymer step runs one body (`_body`) on the static buffers
    of a `StepGraph`: positions, velocities and forces [n, natoms, 3], the
    per-bead energies [n], the dipole payload, the per-evaluated-bead lists,
    the overflow flag and the O step's normals. On a card, when the
    trajectory's closure is ASPC with a warm start (scf='auto' on a SOR or
    ASPC potential) or there is no electrostatics term, each step at a box
    is one replay of a CUDA graph of that body (`captured`); otherwise
    (scf='keep' on a SOR potential, DIIS, cold evaluations, the CPU) the
    same body runs eagerly, every SOR iteration reading its stop test on
    the host. The set-up, the barostat's trial evaluations, the health
    checks and the pressure reports are converged evaluations, eager.

    scf='auto' runs a SOR potential's trajectory under the ASPC closure: a
    per-evaluated-bead history of the last k+2 corrected dipole sets,
    seeded from bead 0's converged dipoles (set_positions, a checkpoint
    without them) and, after an accepted volume move, from each evaluated
    bead's converged dipoles at the new positions and box.
    scf='keep' keeps the potential's closure with the last step's dipoles
    as the start of each bead's SOR loop (scf_warm_start).

    nlist_rebuild_interval k > 1 builds the pair and triplet lists of the
    evaluated beads (contracted or all) at the chunk's steps i with
    i % k == 0, as the JAX package's scan does: the host knows the index,
    so the build runs eagerly into the static list buffers before that
    step (one graph per box; the build is ~0.3 ms at water256, once per k
    steps). It needs lists, a skin, and no barostat. A list, tile or pair
    overflow anywhere in a chunk raises at its end.

    mesh (a parallel.mesh.Mesh) puts the beads over its shards in
    contiguous blocks (n_beads must be a multiple of its size, and
    contraction is refused, as in the JAX package): each bead's evaluation
    runs on its shard's device through the shard's copy of the potential
    (MBPol.to_device), its results gathered on the potential's
    device. The noise is drawn at the full bead shape on that device, so
    the trajectory does not depend on the mesh. Shards on one device keep
    the CUDA graph; shards over several cards run each step eagerly.
    """

    def __init__(self, potential: MBPol, n_beads, dt=1e-4, temperature=300.0, tau0=0.1,
                 thermostat='pile', contraction=None, seed=0, mesh=None, scf_warm_start=True,
                 barostat_pressure=None, barostat_interval=25, nlist_rebuild_interval=1,
                 scf='auto', _eager=False):
        if scf not in ('auto', 'keep'):
            raise ValueError(f"scf must be 'auto' or 'keep', got {scf!r}")
        if mesh is not None:
            if contraction:
                raise ValueError('mesh + contraction is unsupported: the contracted bead set '
                                 'is small and runs unsharded - drop mesh or contraction')
            if not isinstance(mesh, Mesh):
                raise TypeError(f'mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}')
            if int(n_beads) % mesh.size:
                raise ValueError(f'n_beads={n_beads} not divisible by mesh dp={mesh.size}')
        self.mesh = mesh
        if (scf == 'auto' and scf_warm_start and potential.elec_params is not None
                and potential.config.scf_method == 'sor'):
            potential = with_scf_method(potential, 'aspc')
        self.potential = potential
        self.system = potential.system
        self.n_beads = int(n_beads)
        self.dt = float(dt)
        self.temperature = float(temperature)
        self.contraction = contraction
        self.generator = torch.Generator(device=potential.device)
        self.generator.manual_seed(int(seed))
        self._nl_every = max(int(nlist_rebuild_interval), 1)
        self._nl_reuse = self._nl_every > 1
        if self._nl_reuse:
            if not potential.use_neighbor_lists:
                raise ValueError('nlist_rebuild_interval > 1 needs a neighbor-list potential '
                                 '(bulk systems)')
            if potential.config.nlist_skin <= 0:
                raise ValueError('nlist_rebuild_interval > 1 requires nlist_skin > 0 to stay '
                                 'exact across the reuse interval')
            if barostat_pressure is not None:
                raise ValueError('nlist_rebuild_interval > 1 is unsupported under NPT (the box '
                                 'is trajectory state; lists must follow it)')
        self._npt = barostat_pressure is not None
        if self._npt:
            if not potential.system.periodic:
                raise ValueError('barostat_pressure requires a periodic system (PME box)')
            self.barostat_pressure = float(barostat_pressure)
            self.barostat_interval = max(int(barostat_interval), 1)
        has_elec = potential.elec_params is not None
        self._aspc = scf_warm_start and has_elec and potential.config.scf_method == 'aspc'
        self._warm = scf_warm_start and has_elec and potential.config.scf_method != 'aspc'
        self._hist_len = (len(elec.aspc_predictor_coefficients(potential.config.aspc_k))
                          if self._aspc else None)
        if contraction:
            intra, self._eval_pot = mbpol_intra_inter_split(potential)
            self._T = contraction_matrix(self.n_beads, int(contraction))
            self._n_eval = int(contraction)
        else:
            intra, self._eval_pot, self._T = None, potential, None
            self._n_eval = self.n_beads
        bead_pots = None
        if mesh is not None:
            copies = [potential.to_device(d) for d in mesh.devices]
            bead_pots = [copies[shard_of(b, self.n_beads, mesh)] for b in range(self.n_beads)]
        self._ef = _bead_evaluations(self._eval_pot, self.n_beads, contraction, intra,
                                     potential.config.aspc_k if self._aspc else None, bead_pots)
        self._step = make_rpmd_step(self.system, self._ef, self.n_beads, dt, temperature,
                                    tau0=tau0, thermostat=thermostat, batched=True,
                                    with_aux=True, with_box=True)
        self._eager = bool(_eager)
        self.state = None
        self._mu = None
        self._baro = None          # adaptive (scale nm^3, attempted, accepted)
        self._graph = None
        self.capture_ms = []       # host ms of each graph capture so far

    # ------------------------------------------------------------------
    @property
    def captured(self):
        """True when each ring-polymer step replays a CUDA graph (the rule
        in the class docstring)."""
        pot = self.potential
        return (pot.device.type == 'cuda' and not self._eager
                and not (self.mesh is not None and self.mesh.spans_devices)
                and (pot.elec_params is None or self._aspc))

    def _normal(self, shape):
        pot = self.potential
        return torch.randn(shape, generator=self.generator, dtype=pot.dtype, device=pot.device)

    def _uniform(self, shape):
        pot = self.potential
        return torch.rand(shape, generator=self.generator, dtype=pot.dtype, device=pot.device)

    def _to_eval(self, q):
        """The evaluated bead set: the contracted beads, or q itself."""
        return q if self._T is None else _beads(self._T, q)

    def _converged(self, q, box, ovf=None):
        """Converged (cold) evaluations of the beads q at box: (e [n], f,
        aux' of `_ef`)."""
        if ovf is None:
            ovf = torch.zeros((), dtype=torch.bool, device=q.device)
        return self._ef(q, dict(mu=None, nl=None, ovf=ovf), box)

    def _seed_mu(self, dipoles):
        """The payload from dipoles [ne, natoms, 3]: each evaluated bead's
        ASPC history filled with its row (a constant history: the predictor
        returns it), the dipoles themselves (warm start), or None."""
        if self._aspc:
            return dipoles[:, None].repeat(1, self._hist_len, 1, 1)
        return dipoles.clone() if self._warm else None

    def _reseed_mu(self):
        """The payload for the state's positions: bead 0's converged dipoles
        in every slot (ASPC), zeros (warm start), or None."""
        if not (self._aspc or self._warm):
            self._mu = None
            return
        qe = self._to_eval(self.state.positions)
        mu0 = torch.zeros_like(qe)
        if self._aspc:
            diag = self._eval_pot._energy_forces_impl(qe[0], box=self.state.box)[3]
            mu0 = diag['induced_dipoles'][None].expand_as(qe)
        self._mu = self._seed_mu(mu0)

    def set_positions(self, positions, box=None, spread=0.0):
        """Start every bead at `positions` (numpy or tensor; M sites placed
        by the potential), with spread x normals from the generator on the
        real atoms, at rest, with converged forces and energies."""
        pos = self.potential.as_positions(positions)
        normals = self._normal((self.n_beads,) + tuple(pos.shape)) if spread > 0.0 else None
        self.state = initial_state(self.system, pos, self.n_beads, self.temperature, box=box,
                                   spread=spread, normals=normals)
        self._reseed_mu()
        if self._npt:
            self._baro = I.barostat_scale_init(self.state.box)
        e, f, _ = self._converged(self.state.positions, self.state.box)
        self.state = dataclasses.replace(self.state, forces=f, potential_energy=e)

    # ------------------------------------------------------------------
    def _build_lists(self, q):
        """The pair and triplet lists of each evaluated bead of q as
        [pairs, pmask, trips, tmask], each stacked [ne, ...], and their
        overflow flag."""
        built = [self._eval_pot.build_neighbor_lists(p, self.state.box) for p in self._to_eval(q)]
        ovf = built[0][1]['pair_overflow'] | built[0][1]['triplet_overflow']
        for _, d in built[1:]:
            ovf = ovf | d['pair_overflow'] | d['triplet_overflow']
        return [torch.stack([nl[i][j] for nl, _ in built]) for i in (0, 1) for j in (0, 1)], ovf

    def _body(self, g):
        """One ring-polymer step on the static buffers of g: the BAOAB step
        with its evaluations, the centroid-virial kinetic energy and the
        ring-polymer Hamiltonian, written back in place. On a card this is
        what the graph holds. It reads no device value on the host."""
        b = g.buffers
        state = I.MDState(positions=b['positions'], velocities=b['velocities'],
                          forces=b['forces'], potential_energy=b['pe'], box=g.box)
        nl = None
        if 'pairs' in b:
            nl = [((b['pairs'][i], b['pmask'][i]), (b['trips'][i], b['tmask'][i]))
                  for i in range(self._n_eval)]
        state, aux = self._step(state, b['noise'], dict(mu=b.get('mu'), nl=nl, ovf=b['ovf']))
        for k, v in (('positions', state.positions), ('velocities', state.velocities),
                     ('forces', state.forces), ('pe', state.potential_energy),
                     ('ovf', aux['ovf'])):
            b[k].copy_(v)
        b['ke'].copy_(kinetic_energy_virial(self.system, state.positions, state.forces,
                                            self.temperature))
        b['ham'].copy_(ring_polymer_hamiltonian(self.system, state, self.temperature))
        if 'mu' in b:
            b['mu'].copy_(aux['mu'])

    def _run(self, k, ovf):
        """k steps through `_body` on the buffers of a StepGraph (replayed as
        a graph where `captured` says so), the lists built before the steps
        i % nlist_rebuild_interval == 0. Returns (per-step sum of the bead
        energies, KE_cv, H) [3, k] and the overflow flag."""
        s = self.state
        src = dict(positions=s.positions, velocities=s.velocities, forces=s.forces,
                   pe=s.potential_energy, ke=s.potential_energy[0], ham=s.potential_energy[0],
                   ovf=ovf, noise=self._normal(tuple(s.positions.shape)))
        if self._mu is not None:
            src['mu'] = self._mu
        if self._nl_reuse:
            lists, ov = self._build_lists(s.positions)
            src.update(zip(LIST_KEYS, lists))
            src['ovf'] = ovf | ov
        g = self._graph
        if g is None or not g.matches(self._eval_pot, s.box, None, src):
            # a new box (an accepted volume move): the old graph and its
            # memory go, the next step captures anew
            self._graph = g = None
            g = self._graph = StepGraph(self._eval_pot, s.box, None, src, self.captured,
                                        self.capture_ms)
        g.load(src)
        b = g.buffers
        out = torch.empty((3, k), dtype=b['pe'].dtype, device=b['pe'].device)
        for i in range(k):
            if i:
                g.load(dict(noise=self._normal(tuple(b['noise'].shape))))
                if self._nl_reuse and i % self._nl_every == 0:
                    lists, ov = self._build_lists(b['positions'])
                    g.load(dict(zip(LIST_KEYS, lists)))
                    b['ovf'].copy_(b['ovf'] | ov)
            g.step(self._body)
            out[0, i].copy_(torch.sum(b['pe']))
            out[1, i].copy_(b['ke'])
            out[2, i].copy_(b['ham'])
        res = g.unload(skip=('noise', 'ke', 'ham') + LIST_KEYS)
        self.state = dataclasses.replace(s, positions=res['positions'],
                                         velocities=res['velocities'], forces=res['forces'],
                                         potential_energy=res['pe'], step=s.step + k)
        self._mu = res.get('mu')
        return out, res['ovf']

    def _barostat_move(self, ovf):
        """One ring-polymer volume move on converged evaluations; an accepted
        move reseeds the dipole payload from the trial's dipoles. Returns
        (accepted, overflow flag)."""
        trial = dict(ovf=ovf)

        def energy_fn(q, box):
            e, f, aux = self._converged(q, box, trial['ovf'])
            trial['ovf'] = aux['ovf']
            trial.setdefault('dipoles', aux['dipoles'])
            return e, f

        self.state, accepted = rpmd_barostat_move(
            self.system, energy_fn, self.state, self.temperature, self.barostat_pressure,
            self._uniform((2,)), scale_nm3=self._baro[0])
        if accepted and self._mu is not None:
            self._mu = self._seed_mu(trial['dipoles'])
        self._baro = I.barostat_scale_update(self._baro, accepted, float(np.prod(self.state.box)))
        return accepted, trial['ovf']

    def _chunk(self, n):
        """n steps; under NPT in groups of barostat_interval, a volume move
        after each (a short last one included). Returns (per-step [3, n]
        outputs, overflow flag, (moves attempted, accepted))."""
        ovf = torch.zeros((), dtype=torch.bool, device=self.state.positions.device)
        group = self.barostat_interval if self._npt else n
        outs, moves, done = [], [0, 0], 0
        while done < n:
            k = min(group, n - done)
            out, ovf = self._run(k, ovf)
            outs.append(out)
            if self._npt:
                accepted, ovf = self._barostat_move(ovf)
                moves[0] += 1
                moves[1] += int(accepted)
            done += k
        return torch.cat(outs, dim=1), ovf, moves

    def step(self, n_steps, report_interval=None, check_health=True, frame_callback=None,
             report_pressure=False):
        """Advance n_steps. Returns per-report-interval quantum estimators
        (kJ/mol): step, potential_energy (bead mean), kinetic_virial,
        total_energy, and under NPT volume, with report_pressure pressure
        (bar, md/pressure.rpmd_virial_pressure, uncontracted periodic runs
        only); per step step_potential_energy, step_kinetic_virial and
        step_hamiltonian (ring_polymer_hamiltonian); barostat_attempted and
        barostat_accepted.

        A list, tile or pair overflow inside a chunk raises at its end. With
        check_health, a NaN energy or a failed converged evaluation of bead
        0 at the report boundary (SCF, overflow) raises RuntimeError.
        frame_callback(step, centroid_nm, box) gets the bead centroid
        (M sites placed) at each report boundary."""
        report_interval = report_interval or n_steps
        rows = dict(step=[], potential_energy=[], kinetic_virial=[], total_energy=[])
        if self._npt:
            rows['volume'] = []
        if report_pressure:
            if not self.system.periodic:
                raise ValueError('report_pressure needs a periodic system')
            if self.contraction:
                raise ValueError(
                    'report_pressure with ring-polymer contraction is unsupported: the virial '
                    'estimator must match the contracted effective potential - run '
                    'uncontracted or compute the pressure offline')
            from mbpol_openmm_plugin_tpu_torch.md.pressure import rpmd_virial_pressure
            rows['pressure'] = []
        from mbpol_openmm_plugin_tpu_torch.md.simulation import health_flag
        per_step, moves = [], np.zeros(2, np.int64)
        remaining = n_steps
        while remaining > 0:
            k = min(report_interval, remaining)
            out, ovf, chunk_moves = self._chunk(k)
            moves += chunk_moves
            if bool(ovf):
                raise RuntimeError(
                    f'PIMD list, tile or pair overflow in the chunk ending at step '
                    f'{self.state.step}: raise the capacities with tune_capacities or rebuild '
                    'every step')
            host = out.double().cpu().numpy()
            per_step.append(host)
            if check_health:
                nan = np.isnan(host[0])
                diag = self.potential._energy_forces_impl(self.state.positions[0],
                                                          box=self.state.box)[3]
                if nan.any() or not bool(health_flag(diag)):
                    at = (self.state.step - k + int(np.argmax(nan)) if nan.any()
                          else self.state.step)
                    raise RuntimeError(
                        f'PIMD health check failed at step {at}: '
                        f'{ {kk: v for kk, v in diag.items() if kk == "converged" or kk.endswith("_overflow")} }')
            pe_mean = float(host[0, -1]) / self.n_beads
            ke = float(host[1, -1])
            rows['step'].append(self.state.step)
            rows['potential_energy'].append(pe_mean)
            rows['kinetic_virial'].append(ke)
            rows['total_energy'].append(pe_mean + ke)
            if self._npt:
                rows['volume'].append(float(np.prod(self.state.box)))
            if report_pressure:
                rows['pressure'].append(rpmd_virial_pressure(
                    self.potential, self.state.positions, self.temperature, box=self.state.box))
            if frame_callback is not None:
                centroid = compute_virtual_sites(self.system,
                                                 torch.mean(self.state.positions, dim=0))
                frame_callback(self.state.step, centroid.cpu().numpy(),
                               None if self.state.box is None else np.array(self.state.box))
            remaining -= k
        res = {k: np.asarray(v) for k, v in rows.items()}
        steps = np.concatenate(per_step, axis=1)
        res.update(step_potential_energy=steps[0] / self.n_beads, step_kinetic_virial=steps[1],
                   step_hamiltonian=steps[2], barostat_attempted=int(moves[0]),
                   barostat_accepted=int(moves[1]))
        return res

    # ------------------------------------------------------------------
    def checkpoint(self):
        """The dynamic state as numpy arrays: positions, velocities, forces,
        energies, box, step, the generator's state, the dipole payload and
        the adaptive barostat's (scale, attempted, accepted). The lists are
        rebuilt at each chunk's first step, so a resume with the same report
        boundaries is bit-identical to an uninterrupted run without them."""
        s = self.state
        ck = dict(positions=s.positions.cpu().numpy(), velocities=s.velocities.cpu().numpy(),
                  forces=s.forces.cpu().numpy(),
                  potential_energy=s.potential_energy.cpu().numpy(), step=np.asarray(s.step),
                  rng=self.generator.get_state().numpy())
        if s.box is not None:
            ck['box'] = np.asarray(s.box, np.float64)
        if self._mu is not None:
            ck['mu'] = self._mu.cpu().numpy()
        if self._baro is not None:
            ck['baro_scale'] = np.asarray(self._baro[0], np.float64)
            ck['baro_attempted'] = np.asarray(self._baro[1])
            ck['baro_accepted'] = np.asarray(self._baro[2])
        return ck

    def load_checkpoint(self, ck):
        pot = self.potential

        def tensor(a):
            return torch.as_tensor(np.asarray(a), dtype=pot.dtype, device=pot.device)

        self.state = I.MDState(
            positions=tensor(ck['positions']), velocities=tensor(ck['velocities']),
            forces=tensor(ck['forces']), potential_energy=tensor(ck['potential_energy']),
            box=np.array(ck['box'], np.float64) if 'box' in ck else None, step=int(ck['step']))
        self.generator.set_state(torch.as_tensor(np.asarray(ck['rng']), dtype=torch.uint8))
        if 'mu' in ck:
            self._mu = tensor(ck['mu'])
        else:
            # reseed as set_positions does (a converged evaluation under ASPC)
            self._reseed_mu()
        if self._npt:
            self._baro = ((float(ck['baro_scale']), int(ck['baro_attempted']),
                           int(ck['baro_accepted'])) if 'baro_scale' in ck
                          else I.barostat_scale_init(self.state.box))

    def save_checkpoint(self, path):
        np.savez(path, **self.checkpoint())

    def load_checkpoint_file(self, path):
        with np.load(path) as z:
            self.load_checkpoint({k: z[k] for k in z.files})
