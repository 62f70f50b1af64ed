"""The least time the card could take for a kernel's work: the H100 SXM
peaks and the work counts of the direct-space electrostatics kernels,
charged to the in-cutoff site pairs of the run's own positions (the
arithmetic of the port's tools/timing.py and tools/dense_probe.py, kept
here so that later changes to the program cannot move the yardstick).

The bound is the largest of bytes / HBM bandwidth, CUDA-core operations /
fp32 rate and transcendentals / the transcendental unit's rate: the units
run side by side, so their times are not added. The published peaks
assume the 700 W power limit; the result line names the card and the
benchmark prints its power limit beside the numbers.
"""
import subprocess

import numpy as np
import torch

HBM_BPS = 3.35e12              # bytes/s
FP32_FLOPS = 67e12             # CUDA-core fp32 operations/s
MUFU_PER_CLOCK_PER_SM = 16     # transcendental results per clock per SM

# operations per site pair: the cutoff test (differences, minimum image,
# r^2, sqrt, compare), then the chain of the fixed field and SCF factors
# (K1) and of the energy, forces and potential (K2); the chain's
# transcendentals go to the transcendental unit
OPS_TEST, OPS_K1, OPS_K2 = 25, 60, 150
TRANS_K1, TRANS_K2 = 6, 7


def smi(query):
    out = subprocess.run(['nvidia-smi', f'--query-gpu={query}', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def transcendental_rate():
    """Results per second of the transcendental unit at the card's maximum
    SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return MUFU_PER_CLOCK_PER_SM * sms * float(smi('clocks.max.sm').split()[0]) * 1e6


def bound_s(n_bytes, n_ops, n_trans=0, rate=None):
    """Least seconds for the work (the largest of the three times)."""
    t = [n_bytes / HBM_BPS, n_ops / FP32_FLOPS]
    if n_trans:
        t.append(n_trans / rate)
    return max(t)


def in_cutoff_pairs(sites, box, cutoff, chunk=2048):
    """Unordered site pairs (i < j, the same water included) whose
    minimum-image distance is under the cutoff."""
    n = sites.shape[0]
    b = torch.as_tensor(np.asarray(box, np.float64), dtype=sites.dtype, device=sites.device)
    total = 0
    for r0 in range(0, n, chunk):
        d = sites[None, :, :] - sites[r0:r0 + chunk, None, :]
        d = d - torch.floor(d / b + 0.5) * b
        r2 = torch.sum(d * d, dim=-1)
        i = torch.arange(r0, min(r0 + chunk, n), device=sites.device)[:, None]
        j = torch.arange(n, device=sites.device)[None, :]
        total += int(torch.sum((r2 < cutoff * cutoff) & (j > i)))
    return total


def dense_bounds(n, n_in, rate):
    """{kernel: seconds per launch} of the dense K1 and K2 on n sites with
    n_in unordered in-cutoff pairs: each such pair's chain once, the packed
    sites and dipoles read once, the outputs (K1's whole s3/s5) written
    once."""
    return {'fixed_field_tri_kernel': bound_s(n * 32 + n * 12 + 2 * n * n * 4,
                                              n_in * (OPS_TEST + OPS_K1), n_in * TRANS_K1, rate),
            'direct_efp_tri_kernel': bound_s(n * 32 + n * 12 + n * 20,
                                             n_in * (OPS_TEST + OPS_K2), n_in * TRANS_K2, rate)}


def share(kernels, bounds, helpers):
    """Roofline share (%) of a group of kernels: the sum over their launches
    of each launch's bound over the sum of their device time (with the
    helper kernels they launch); None where the trace holds none of them.
    kernels: {name: (device seconds, launches)} by name fragment."""
    t = sum(kernels.get(k, (0.0, 0))[0] for k in list(bounds) + list(helpers))
    b = sum(kernels.get(k, (0.0, 0))[1] * s for k, s in bounds.items())
    if t <= 0 or b <= 0:
        return None
    return 100.0 * b / t
