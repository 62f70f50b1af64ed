"""Device constants: host values (numpy arrays, tuples, scalars) copied to a
device once and reused.

A copy from pageable host memory to the card waits for the stream, and a
CUDA graph capture refuses it, so the evaluation layers take their tables,
index arrays and boxes from here: `device_const` keys a tensor on the
value's bytes, its dtype and the target device, so a box gets its own
entry and a barostat's new box a new one. The cache holds at most
MAX_ENTRIES tensors and drops the least recently used; a captured graph
keeps its own references to what it read (`recording`), so a tensor a
graph replays from is never freed under it.
"""
from __future__ import annotations

import collections
import contextlib

import numpy as np
import torch

MAX_ENTRIES = 1024

_CACHE: collections.OrderedDict = collections.OrderedDict()
_RECORDERS: list = []


def cached(key, build):
    """The tensor build() returns, built once per hashable `key`."""
    t = _CACHE.get(key)
    if t is None:
        t = build()
        _CACHE[key] = t
        if len(_CACHE) > MAX_ENTRIES:
            _CACHE.popitem(last=False)
    else:
        _CACHE.move_to_end(key)
    for rec in _RECORDERS:
        rec.append(t)
    return t


def device_const(value, dtype=None, device=None):
    """`torch.as_tensor(value, dtype=dtype, device=device)`, copied once per
    value, dtype and device. The tensor is shared: never write to it."""
    a = np.asarray(value)
    key = ('value', a.dtype.str, a.shape, a.tobytes(), dtype, torch.device(device or 'cpu'))
    return cached(key, lambda: torch.as_tensor(a, dtype=dtype, device=device))


@contextlib.contextmanager
def recording():
    """Collects every tensor the cache hands out inside the block into the
    list it yields (a graph capture keeps them alive with it)."""
    rec = []
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)
