"""One MD step as a CUDA graph: the static buffers a step reads and writes,
its capture after a warm-up step, its replay, and the kernel wrappers'
launch counts across replays.

`Simulation` (md/simulation.py) runs every step through one body,
`Simulation._body`, on the buffers of a `StepGraph`, and
`PIMDSimulation` (md/rpmd.py) every ring-polymer step through
`PIMDSimulation._body` on bead-leading buffers: on a card, when its
configuration is captured, the first step at a box runs the body eagerly on
a side stream (it builds the kernels, warms autograd, the cuFFT plans and
the constant caches), the second records it into a `torch.cuda.CUDAGraph`,
and every later step at that box replays the graph. Otherwise every step
runs the body as it stands. A failed capture or replay raises; nothing
falls back to the eager step.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from mbpol_openmm_plugin_tpu_torch.utils import consts, tracing

LIST_KEYS = ('pairs', 'pmask', 'trips', 'tmask')

_BODY_DEPTH = [0]


def in_step():
    """True while a step body runs (eagerly or being recorded): host work,
    such as the native neighbor lists, refuses to run there."""
    return _BODY_DEPTH[0] > 0


@contextlib.contextmanager
def _body_running():
    _BODY_DEPTH[0] += 1
    try:
        yield
    finally:
        _BODY_DEPTH[0] -= 1


def kernel_wrappers():
    """Every wrapper of a hand-written kernel, with its `launches` count."""
    from mbpol_openmm_plugin_tpu_torch.ops import elec_direct, elec_direct_bs, pip_fused
    return (elec_direct.KERNELS + elec_direct.ROW_KERNELS + elec_direct_bs.KERNELS
            + pip_fused.KERNELS)


class LaunchLedger:
    """Launch counts of a captured step. A wrapper counts one where it
    launches its kernel, also while a graph is being recorded, when no
    kernel runs; a replay runs the recorded kernels and calls no wrapper.
    So `end_capture` takes the capture's increments back and keeps them,
    and `replayed` adds them once per replay."""

    def __init__(self, wrappers):
        self.wrappers = tuple(wrappers)
        self.per_replay = None
        self._before = None

    def begin_capture(self):
        self._before = [w.launches for w in self.wrappers]

    def end_capture(self):
        self.per_replay = [w.launches - b for w, b in zip(self.wrappers, self._before)]
        for w, b in zip(self.wrappers, self._before):
            w.launches = b

    def replayed(self, n=1):
        for w, d in zip(self.wrappers, self.per_replay):
            w.launches += n * d


class StepGraph:
    """The static buffers of one MD step at one box, and on a card the step
    captured as a graph (`capture=True`).

    `sources` names each buffer and the tensor it is first loaded from (or
    shaped like): for `Simulation`, `md_step_sources`; for `PIMDSimulation`,
    bead-leading positions, velocities, forces and energies, the dipole
    payload, per-bead lists and the O step's normals. B: the ASPC
    predictor coefficients the body reads (Simulation; None else). `load`
    copies tensors in by name, `step` advances the buffers one step,
    `unload` hands out copies."""

    def __init__(self, pot, box, B, sources, capture, captures=None):
        self.box = None if box is None else np.array(box, np.float64)
        self.B = B
        self.capture = capture
        self.signature = self._signature(pot, box, B, sources)
        # what the graph reads by address and the potential may replace
        self.keep = (pot._block_info, pot._tables)
        self.buffers = {k: torch.empty_like(v) for k, v in sources.items()}
        self.graph = None
        self.ledger = LaunchLedger(kernel_wrappers())
        self.pinned = None
        # the owner's list of capture times (host ms), appended at each capture
        self.captures = captures if captures is not None else []

    @staticmethod
    def _signature(pot, box, B, src):
        box = None if box is None else np.asarray(box, np.float64).tobytes()
        return (box, id(B), id(pot._block_info), id(pot._tables),
                tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(src.items())))

    def matches(self, pot, box, B, sources):
        """True when this graph serves a step of pot at `box` with these
        buffers: the same box, the same potential tables and buffers of the
        same names, shapes and dtypes."""
        return self._signature(pot, box, B, sources) == self.signature

    def lists(self):
        """((pairs, pmask), (trips, tmask)) of the buffers, or None."""
        b = self.buffers
        if 'pairs' not in b:
            return None
        return (b['pairs'], b['pmask']), (b['trips'], b['tmask'])

    def load(self, sources):
        """Copy each named tensor into its buffer."""
        for k, v in sources.items():
            self.buffers[k].copy_(v)

    def unload(self, skip=()):
        """Copies of the buffers not named in `skip`."""
        return {k: v.clone() for k, v in self.buffers.items() if k not in skip}

    def step(self, body):
        """Advance the buffers one step: body(self), or the graph's replay."""
        if not self.capture:
            with _body_running():
                body(self)
        elif self.graph is not None:
            with tracing.span('md.step_graph.replay'):
                self.graph.replay()
            tracing.count('graph_replays')
            self.ledger.replayed()
        else:
            self._warm_up_and_capture(body)

    def _warm_up_and_capture(self, body):
        """The first step at this box: body(self) on a side stream (the real
        step), then body(self) recorded into a graph, which runs nothing."""
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream(device=cur.device)
        side.wait_stream(cur)
        with tracing.phase('md.step_graph.eager_step'):
            with torch.cuda.stream(side), _body_running():
                body(self)
        cur.wait_stream(side)
        with tracing.phase('md.step_graph.capture') as capture:
            graph = torch.cuda.CUDAGraph()
            self.ledger.begin_capture()
            try:
                with consts.recording() as pinned, torch.cuda.graph(graph), _body_running():
                    body(self)
            finally:
                self.ledger.end_capture()
        self.captures.append(capture.seconds * 1e3)
        self.graph, self.pinned = graph, pinned
