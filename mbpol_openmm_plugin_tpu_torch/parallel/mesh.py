"""A device mesh for one process (port of
mbpol_openmm_plugin_tpu/parallel/mesh.py).

The JAX package's mesh is single-controller: one process holds a
jax.sharding.Mesh of N devices and XLA places each shard and inserts the
collectives. The port keeps that shape with no process group: a `Mesh` is
an ordered tuple of torch devices, one per shard on a 1-D 'dp' axis, and
each sharded function splits its own work.

- Each shard's work is launched on its shard's device (`on_shard`: the
  kernels take that device's current stream).
- Small replicated operands (positions, dipoles, the PME grid) are copied
  to each shard with `.to()`.
- Row outputs are gathered, and partial sums added in shard order, on the
  mesh's first device, the lead (`gather_rows`, `sum_to_lead`): the same
  bits on every run, with no atomics across shards.
- Autograd crosses devices through `.to()` as it does on one device.

What is split: the one-body molecule batch, the 2B pair and 3B triplet
batches, the dispersion pair-grid rows (or the water-pair batch), the
dense direct-space rows (kernels #3/#4 of the JAX package, one row range
of the full grid per shard), the block path's row tiles with a local tile
list per shard, the sparse path's water pairs and the PME grid's sites
(per-shard partial grids added on the lead, one convolution there, each
shard reading back its sites). JAX's `replicated`, `row_sharded` and
`constrain` are XLA placement hints; their counterpart is the explicit
split in each function, so they have no copies here.

A mesh may name one device more than once: the CPU tests put 8 shards on
'cpu' (the counterpart of the JAX tests' 8 virtual host devices), and one
card can hold 4 shards on 'cuda:0', which launches every per-shard kernel
and every gather and sum of the meshed path.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

# the row multiple of one shard of the dense direct space (the JAX
# package's 256-site tile, elec_pallas.TI)
ROW_TILE = 256


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Shards on a 1-D axis: devices[k] holds shard k."""
    devices: tuple
    axis: str = 'dp'

    @property
    def size(self):
        return len(self.devices)

    @property
    def lead(self):
        """The device of shard 0, where gathers and sums land."""
        return self.devices[0]

    def distinct(self):
        """The devices in shard order, each once."""
        return tuple(dict.fromkeys(self.devices))

    @property
    def spans_devices(self):
        """True when the shards sit on more than one device."""
        return len(self.distinct()) > 1


def _device(d):
    d = torch.device(d)
    if d.type == 'cuda' and d.index is None:
        d = torch.device('cuda', torch.cuda.current_device())
    return d


def make_mesh(n_devices=None, devices=None, axis='dp'):
    """A Mesh over `devices` (an explicit list; repeats allowed), or over the
    first n_devices visible CUDA cards (all of them when None). Raises when
    fewer cards are visible than asked for."""
    if devices is not None:
        devs = tuple(_device(d) for d in devices)
        if not devs or (n_devices is not None and n_devices != len(devs)):
            raise ValueError(f'n_devices={n_devices} does not match devices={devices}')
        if len({d.type for d in devs}) > 1:
            raise ValueError(f'a mesh holds devices of one type, got {devices}')
        for d in devs:
            if d.type == 'cuda' and d.index >= torch.cuda.device_count():
                raise RuntimeError(f'make_mesh: {d} is not visible')
        return Mesh(devs, axis)
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = visible if n_devices is None else int(n_devices)
    if n < 1 or n > visible:
        raise RuntimeError(f'make_mesh: {n} CUDA device(s) asked for, {visible} visible; pass '
                           "devices=[...] for another layout (e.g. ['cpu'] * 8)")
    return Mesh(tuple(torch.device('cuda', k) for k in range(n)), axis)


def or_one(mesh, device):
    """mesh, or when None a mesh of one shard on `device`: the unmeshed
    form of a sharded function (one part, every gather and sum of one)."""
    return mesh if mesh is not None else Mesh((torch.device(device),))


def round_up(n, k):
    return ((n + k - 1) // k) * k


def padded_for_mesh(n, n_devices):
    """Row count of the sharded dense direct space: a multiple of
    ROW_TILE * n_devices, so every shard holds whole tiles
    (elec_pallas.padded_for_mesh)."""
    return round_up(n, ROW_TILE * n_devices)


def row_ranges(n_rows, mesh):
    """The contiguous equal slabs [(lo, hi)] of n_rows rows, one per shard
    (ceil(n_rows / size) rows each; the last ones may be short or empty)."""
    step = -(-n_rows // mesh.size)
    return [(min(k * step, n_rows), min((k + 1) * step, n_rows)) for k in range(mesh.size)]


def on_shard(device):
    """Context for launching a shard's work: the device is current (so
    torch.cuda.current_stream() is its stream) on a card; nothing on the
    CPU."""
    if device.type == 'cuda':
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def gather_rows(mesh, parts):
    """The row blocks `parts` (one per shard, in shard order) concatenated
    on the lead device."""
    if len(parts) == 1:
        return parts[0].to(mesh.lead)
    return torch.cat([p.to(mesh.lead) for p in parts])


def sum_to_lead(mesh, parts):
    """The sum of `parts` (one per shard) on the lead device, added in
    shard order."""
    acc = parts[0].to(mesh.lead)
    for p in parts[1:]:
        acc = acc + p.to(mesh.lead)
    return acc


def any_to_lead(mesh, flags):
    """The logical or of the bool tensors `flags` (one per shard) on the
    lead device."""
    acc = flags[0].to(mesh.lead)
    for f in flags[1:]:
        acc = acc | f.to(mesh.lead)
    return acc


def map_rows(mesh, n_rows, fn):
    """[fn(device, lo, hi) for each shard's slab of row_ranges(n_rows)],
    each call on its shard (`on_shard`), empty slabs skipped."""
    out = []
    for dev, (lo, hi) in zip(mesh.devices, row_ranges(n_rows, mesh)):
        if hi > lo:
            with on_shard(dev):
                out.append(fn(dev, lo, hi))
    return out


def to_device(obj, device):
    """obj with every tensor in it (nested tuples and lists) moved to
    `device`; None stays None."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(x, device) for x in obj)
    return obj


def shard_of(index, n_items, mesh):
    """The shard that holds item `index` of n_items split in contiguous
    blocks (beads, replicas): floor(index * size / n_items)."""
    return index * mesh.size // n_items
