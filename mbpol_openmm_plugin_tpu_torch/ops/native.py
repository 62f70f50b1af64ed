"""ctypes binding of the host voxel-hash neighbor lists (native/neighbor_list.cpp),
the port's own copy of the JAX package's ops/native.py.

The library is compiled from the checkout's source with g++ into the
package's `_build/` directory, keyed on a hash of the source and the
flags (a change to either rebuilds); nothing is written beside the source.
Without a compiler, or when the build fails, the call raises: callers get
the error, not another list builder.

The lists are host work: positions are copied to the host, listed in
float64 in O(N) and returned as int32 numpy arrays.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

from mbpol_openmm_plugin_tpu_torch.ops._build import BUILD_DIR

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(REPO_DIR, 'native', 'neighbor_list.cpp')
CXX_FLAGS = ('-O2', '-fPIC', '-shared', '-std=c++17')


def library_path():
    """The keyed library path in _build/ for the current source and flags."""
    h = hashlib.sha256(' '.join(CXX_FLAGS).encode())
    with open(SOURCE, 'rb') as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f'libmbpol_native_{h.hexdigest()[:16]}.so')


def build():
    """Compile native/neighbor_list.cpp with g++ into _build/ unless the
    keyed library exists. Returns its path; raises RuntimeError without
    g++ or with the compiler's output when it fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which('g++')
    if cxx is None:
        raise RuntimeError('g++ not found on PATH: the native neighbor lists are built from '
                           'native/neighbor_list.cpp with g++')
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, '-o', tmp, SOURCE], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'g++ failed on {SOURCE}:\n{proc.stderr}')
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    lib = ctypes.CDLL(build())
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int32)
    for name in ('mbpol_pair_list', 'mbpol_triplet_list'):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [dp, ctypes.c_int64, dp, ctypes.c_double, ip, ctypes.c_int64]
    return lib


def _call(name, o_pos, box, cutoff, capacity, width):
    pos = np.ascontiguousarray(np.asarray(o_pos, np.float64))
    out = np.zeros((capacity, width), np.int32)
    if box is None:
        b, bp = None, ctypes.POINTER(ctypes.c_double)()
    else:
        b = np.ascontiguousarray(np.asarray(box, np.float64))
        bp = b.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    found = getattr(_lib(), name)(pos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(pos),
                                  bp, float(cutoff),
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), capacity)
    return out[:min(found, capacity)], int(found)


def pair_list(o_pos, box, cutoff, capacity=None):
    """Host O(N) voxel-hash pair list (i < j within cutoff; box None: no
    periodic image). Returns (pairs [min(found, capacity), 2] int32,
    found)."""
    return _call('mbpol_pair_list', o_pos, box, cutoff, capacity or len(o_pos) * 64, 2)


def triplet_list(o_pos, box, cutoff, capacity=None):
    """Host O(N) triplet list: every triplet with >= 2 O-O edges within the
    cutoff, once, as (i, center, k). Returns (triplets [min(found,
    capacity), 3] int32, found)."""
    return _call('mbpol_triplet_list', o_pos, box, cutoff, capacity or len(o_pos) * 256, 3)
