"""What decides `correct`: the program's outputs of a run against the
plain reference (`reference/`), number by number, each beside its limit.

The numbers (kJ/mol, or shares of the reference's largest force or
velocity change):

- pe_step: the potential energy the last timed step produced (the ASPC
  closure in the step graph; under the barostat the last move's converged
  energy) against the reference's converged energy at the final positions
  and box;
- f_step: the forces the last timed step left in the state, the largest
  gap over atoms over the reference's largest force;
- e_<term>: each term of the program's converged evaluation at the final
  state (the health check's call) against the reference's term;
- f_conv: that evaluation's forces, as f_step;
- dv_warmup: the velocity change over the first group of steps of the
  set-up's call (the same entry, the captured step), the largest gap over
  atoms over the reference's largest change; the reference integrates the
  same steps from the same start (and, under Langevin, the same noise);
- e_trial, f_trial: the barostat's last trial evaluation (a converged one
  at the trial's positions and box), its energy and its forces as f_step;
- e_drift (NVE): the change of the total energy over the timed window, the
  reference's potential energy at the window's first and last positions
  plus the kinetic energy of the program's velocities there.

Only the numbers named in the cell's limits file are compared: those whose
limit lies between the program's own readings and a reading that fails,
the control's (the reference in float32 with TF32 products) or a term's
left out of the program's answer. The others are printed as readings.
"""
import math

import numpy as np
import torch

from port_bench.reference import mbpol as R

TERMS = R.TERMS
KB = 0.00831446261815324


def host(t):
    return t.detach().to('cpu', torch.float64).numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float64)


def program_outputs(run, start=None):
    """The program's outputs of a finished run as host float64 arrays;
    start: the window's first state (sut.Run.snapshot)."""
    s = run.sim.state
    e_c, f_c, parts = run.converged()
    st_in, st_out, draws = run.groups[0]
    out = dict(positions=host(s.positions), box=np.array(s.box, np.float64),
               pe_step=float(s.potential_energy), f_step=host(s.forces),
               terms={k: float(v) for k, v in parts.items()}, f_conv=host(f_c),
               warmup=dict(x0=host(st_in.positions), v0=host(st_in.velocities),
                           box=np.array(st_in.box, np.float64),
                           v1=host(st_out.velocities), steps=int(st_out.step - st_in.step),
                           noise=[host(d['noise']) for d in draws if 'noise' in d]))
    if start is not None:
        out['window'] = dict(x0=start['x'], v0=start['v'], box0=start['box'],
                             v1=host(s.velocities))
    if run.trials:
        p, box, e, f = run.trials[0]
        out['trial'] = dict(positions=host(p), box=box, energy=float(e), forces=host(f))
    return out


class Reference:
    """The reference (or, in float32 with TF32 allowed, the control) over
    one configuration and mix."""

    def __init__(self, config, mix, masses, device, dtype=torch.float64):
        self.settings = {k: config[k] for k in ('cutoff', 'ewald_error_tolerance',
                                                'dispersion_switch_width', 'cutoff_2b',
                                                'cutoff_3b')}
        self.mix, self.device, self.dtype = mix, device, dtype
        self.dt = float(config['timestep_fs']) * 1e-3
        m = np.asarray(masses, np.float64)
        self.inv_m = np.where(m > 0, 1.0 / np.where(m > 0, m, 1.0), 0.0)[:, None]

    def evaluate(self, positions, box):
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.dtype == torch.float32
        try:
            r = R.evaluate(positions, box, self.settings, dtype=self.dtype, device=self.device,
                           scf_epsilon=1e-8)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        r['forces'] = host(r['forces'])
        return r

    def warmup_velocity(self, w):
        """v after w['steps'] steps from (x0, v0) in box: velocity Verlet, or
        BAOAB Langevin with the run's noise."""
        x, v, dt, inv_m = w['x0'].copy(), w['v0'].copy(), self.dt, self.inv_m
        f = self.evaluate(x, w['box'])['forces']
        langevin = self.mix['ensemble'] == 'npt' and self.mix.get('thermostat') == 'langevin'
        if langevin:
            kt = KB * float(self.mix['temperature_k'])
            c1 = math.exp(-float(self.mix['friction_per_ps']) * dt)
            c2 = math.sqrt((1.0 - c1 * c1) * kt)
        for i in range(w['steps']):
            v = v + 0.5 * dt * f * inv_m
            if langevin:
                x = x + 0.5 * dt * v
                v = c1 * v + c2 * np.sqrt(inv_m) * w['noise'][i]
                x = x + 0.5 * dt * v
            else:
                x = x + dt * v
            f = self.evaluate(x, w['box'])['forces']
            v = v + 0.5 * dt * f * inv_m
        return v

    def outputs(self, positions, box, warmup, trial, window=None):
        """The reference's values of the numbers' quantities."""
        r = self.evaluate(positions, box)
        out = dict(energy=r['energy'], forces=r['forces'], terms=r['terms'],
                   v1=self.warmup_velocity(warmup))
        if window is not None and self.mix['ensemble'] == 'nve':
            out['energy_window_start'] = self.evaluate(window['x0'], window['box0'])['energy']
        if trial is not None:
            t = self.evaluate(trial['positions'], trial['box'])
            out['trial'] = dict(energy=t['energy'], forces=t['forces'])
        return out

    def as_program(self, ref_out):
        """The control put in the program's place: its outputs shaped as
        `program_outputs`' (converged values stand for the step's)."""
        return dict(pe_step=ref_out['energy'], f_step=ref_out['forces'],
                    terms=ref_out['terms'], f_conv=ref_out['forces'],
                    warmup_v1=ref_out['v1'], trial=ref_out.get('trial'))


def _rel_max(a, b, mask):
    return float(np.max(np.abs(a - b)[mask]) / np.max(np.abs(b)[mask]))


def kinetic(v, masses):
    """Kinetic energy (kJ/mol) of velocities v (nm/ps), masses in amu."""
    return 0.5 * float(np.sum(np.asarray(masses, np.float64)[:, None] * v * v))


def readings(prog, ref, warmup, masses):
    """{number: reading} of program values `prog` (program_outputs, or a
    control's `as_program`) against the reference's `ref`."""
    real = (np.asarray(masses) > 0)
    out = dict(pe_step=abs(prog['pe_step'] - ref['energy']),
               f_step=_rel_max(prog['f_step'], ref['forces'], real),
               f_conv=_rel_max(prog['f_conv'], ref['forces'], real))
    for k in TERMS:
        out['e_' + k] = abs(prog['terms'][k] - ref['terms'][k])
    out['dv_warmup'] = _rel_max(prog['warmup_v1'] - warmup['v0'], ref['v1'] - warmup['v0'],
                                real)
    if prog.get('trial') is not None and 'trial' in ref:
        out['e_trial'] = abs(prog['trial']['energy'] - ref['trial']['energy'])
        out['f_trial'] = _rel_max(prog['trial']['forces'], ref['trial']['forces'], real)
    if prog.get('window') is not None and 'energy_window_start' in ref:
        w = prog['window']
        out['e_drift'] = abs(ref['energy'] + kinetic(w['v1'], masses)
                             - ref['energy_window_start'] - kinetic(w['v0'], masses))
    return out


def program_values(out):
    """program_outputs reshaped for `readings`."""
    return dict(pe_step=out['pe_step'], f_step=out['f_step'], terms=out['terms'],
                f_conv=out['f_conv'], warmup_v1=out['warmup']['v1'],
                trial=out.get('trial'), window=out.get('window'))


def judge(values, limits):
    """(correct, {number: [reading, limit]}) over the numbers with a limit.
    A number that cannot be read (NaN, or missing) fails."""
    table = {}
    ok = True
    for name, limit in limits['numbers'].items():
        v = values.get(name, float('nan'))
        good = bool(np.isfinite(v) and v <= limit)
        ok = ok and good
        table[name] = [v, limit]
    return ok, table
