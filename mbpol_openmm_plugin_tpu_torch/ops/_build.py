"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled at first use with nvcc, one nvcc process per
`.cu` file, all started together, and linked into one shared library with
a plain C interface, which is loaded with ctypes (no PyTorch headers, so a
build takes seconds). The library lands in the package's `_build/`
directory, keyed on a hash of the sources and the nvcc flags: a change to
either triggers a rebuild. Nothing is downloaded; only the sources in this
checkout are compiled.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

from mbpol_openmm_plugin_tpu_torch.utils import tracing

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(PKG_DIR, '_build')

ARCH = ('-gencode', 'arch=compute_90a,code=sm_90a')
NVCC_FLAGS = ARCH + ('-std=c++17', '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    raise RuntimeError('nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); '
                       'the CUDA kernels are built from csrc/ with the CUDA toolkit')


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, '*.cu'))
                  + glob.glob(os.path.join(CSRC_DIR, '*.cuh')))


def build_key():
    """Hash of the kernel sources and the nvcc flags."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, 'rb') as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path():
    return os.path.join(BUILD_DIR, f'libmbpol_kernels_{build_key()}.so')


def build():
    """Compile each csrc/*.cu in its own nvcc process (all at once), then
    link the objects into the keyed shared library, unless it exists.
    Returns its path. Raises RuntimeError with nvcc's output on failure.
    The compiler's resource report (-Xptxas -v: registers, spills) is kept
    beside the library as <name>.log."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        jobs = []
        for src in (p for p in _sources() if p.endswith('.cu')):
            stem = os.path.join(work, os.path.basename(src)[:-3])
            cmd = [_nvcc(), *NVCC_FLAGS, '-c', '-o', stem + '.o', src]
            with open(stem + '.log', 'w') as log:
                jobs.append((cmd, stem, subprocess.Popen(cmd, stdout=log,
                                                         stderr=subprocess.STDOUT)))
        failed = [(cmd, stem) for cmd, stem, proc in jobs if proc.wait() != 0]
        logs = []
        for _, stem, _ in jobs:
            with open(stem + '.log') as f:
                logs.append(f.read())
        if failed:
            cmd, stem = failed[0]
            with open(stem + '.log') as f:
                raise RuntimeError(f'nvcc failed: {" ".join(cmd)}\n{f.read()}')
        tmp = os.path.join(work, 'lib.so')
        cmd = [_nvcc(), *ARCH, '-shared', '-o', tmp, *(stem + '.o' for _, stem, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc link failed: {" ".join(cmd)}\n{proc.stderr}')
        with open(out[:-3] + '.log', 'w') as f:
            f.write(''.join(logs) + proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


@functools.lru_cache(maxsize=None)
def load():
    """The loaded kernel library (built on first use, then cached for the
    process), with argtypes set."""
    with tracing.phase('ops._build.load'):
        lib = ctypes.CDLL(build())
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    consts = [f32] * 10     # alpha, cutoff^2, 5 Thole gammas, box
    # dense kernels (csrc/elec_direct.cu): sites, [mu,] n, consts, tile,
    # partials scratch, outputs, stream
    lib.mbpol_fixed_field_scf.argtypes = [ptr, i32, *consts, i32, ptr, ptr, ptr, ptr, ptr]
    lib.mbpol_fixed_field_scf.restype = i32
    lib.mbpol_direct_efp.argtypes = [ptr, ptr, i32, *consts, i32, ptr, ptr, ptr, ptr, ptr]
    lib.mbpol_direct_efp.restype = i32
    # the full-grid row kernels: sites, n, row0, n_rows, n_cols, consts,
    # tile, partials, tickets, field, s3, s5, stream; sites, mu, n, row0,
    # n_rows, consts, tile, partials, tickets, force, pot, e_row, stream;
    # their column groups (n_rows, n_cols), which size the partials
    lib.mbpol_fixed_field_scf_rows.argtypes = [ptr, i32, i32, i32, i32, *consts, i32, ptr, ptr,
                                               ptr, ptr, ptr, ptr]
    lib.mbpol_fixed_field_scf_rows.restype = i32
    lib.mbpol_direct_efp_rows.argtypes = [ptr, ptr, i32, i32, i32, *consts, i32, ptr, ptr, ptr,
                                          ptr, ptr, ptr]
    lib.mbpol_direct_efp_rows.restype = i32
    lib.mbpol_rows_groups.argtypes = [i32, i32]
    lib.mbpol_rows_groups.restype = i32
    lib.mbpol_empty_launch.argtypes = [ptr]
    lib.mbpol_empty_launch.restype = i32
    # block-sparse kernels (csrc/elec_direct_bs.cu): list pointers tj, meta,
    # row_start; the tiles: n_tiles, row_tile0, n_row_tiles
    lists = [ptr, ptr, ptr]
    tiles = [i32, i32, i32]
    # K1-bs: sites, n, tiles, lists, consts, n_lines, box scratch, field,
    # s3, s5, line_entry, line_count, stream
    lib.mbpol_fixed_field_scf_bs.argtypes = [ptr, i32, *tiles, *lists, *consts, i32, ptr, ptr,
                                             ptr, ptr, ptr, ptr, ptr]
    lib.mbpol_fixed_field_scf_bs.restype = i32
    # K3-bs: sites, mu, tiles, tj, consts, n_lines, s3, s5, line_entry,
    # line_count, field, stream
    lib.mbpol_scf_field_bs.argtypes = [ptr, ptr, *tiles, ptr, *consts, i32, ptr, ptr, ptr, ptr,
                                       ptr, ptr]
    lib.mbpol_scf_field_bs.restype = i32
    # K2-bs takes n, the tiles and the cluster-box scratch
    lib.mbpol_direct_efp_bs.argtypes = [ptr, ptr, i32, *tiles, *lists, *consts, ptr, ptr, ptr,
                                        ptr, ptr]
    lib.mbpol_direct_efp_bs.restype = i32
    # fused PIP kernels (csrc/pip_fused.cu): x, p, v, tables..., e, g, stream
    # Et tiles, factors, coefficients, number of tiles
    lib.mbpol_pip_monomial.argtypes = [ptr, i32, i32, ptr, ptr, ptr, i32, ptr, ptr, ptr]
    lib.mbpol_pip_monomial.restype = i32
    # x, p, v, bp, idx, W tiles, F tiles, e, g, stream
    for fn in (lib.mbpol_pip_quad_explog, lib.mbpol_pip_quad_product):
        fn.argtypes = [ptr, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr]
        fn.restype = i32
    # xat, p, v, bp, W tiles, F tiles, e, g, stream (no index table)
    lib.mbpol_pip_quad_vech.argtypes = [ptr, i32, i32, i32, ptr, ptr, ptr, ptr, ptr]
    lib.mbpol_pip_quad_vech.restype = i32
    return lib


def build_log():
    """The compiler's resource report of the current build ('' if none)."""
    log = library_path()[:-3] + '.log'
    if not os.path.exists(log):
        return ''
    with open(log) as f:
        return f.read()
