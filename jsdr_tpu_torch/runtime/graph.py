"""A stage's step replayed from captured CUDA graphs (:class:`GraphStep`,
for any step function: ``TelemetryStage``'s, ``SpectrumTelemetryStage``'s
and ``SpectrumStage``'s, whose step has no state)."""

from __future__ import annotations

import gc

import numpy as np
import torch

from ..ops._build import LAUNCH_COUNTERS
from .device import holding
from .state import tree_leaves, tree_map


def _copy(dst, src) -> None:
    for d, x in zip(tree_leaves(dst), tree_leaves(src)):
        d.copy_(x)


class GraphStep:
    """A step that its caller runs on the same shapes and arguments block
    after block, replayed from captured CUDA graphs: one graph launch a
    block in place of the step's launches. The step is the ``fn`` the
    caller passes, called as ``fn(iq, states=states, **kw)`` and returning
    its outputs, then the new state (trees of tensors,
    :mod:`~jsdr_tpu_torch.runtime.state`). The kernels, their order and
    their arithmetic are the eager step's, so the outputs and state are
    bit for bit the same (tests/test_torch_graph_step.py).

    A call takes the step, its input, its state, a ``slot``, the index of
    the block's outputs among those the caller still holds, and the
    step's other arguments ``kw``. The key ``(fn, the input's shapes,
    dtypes and device, kw)`` (lists and arrays in ``kw`` by their values)
    selects the graphs: the first block of a key runs eagerly (it loads
    the kernel library, builds plans and uploads the key's tables), later
    blocks capture a graph for each (slot, state set) on first use and
    replay it after. A new key drops the old graphs. A step made with
    ``graphable`` false (its owner's ruling: off a card, or a step that a
    graph cannot hold), or called at a slot outside ``[0, slots)``, runs
    eagerly. ``last`` names what the latest call did: "replay", "capture"
    (a new graph, then its replay) or "eager".

    The step holds, for its key, every cached device table the key's
    step reads (:func:`~jsdr_tpu_torch.runtime.device.holding`): a
    graph keeps no tensor alive, so a table that a cache evicted could
    otherwise go back to the allocator while a graph still reads it.

    State is never written in place: the graphs read one of two static
    state sets and write the other, and a call returns the set it wrote.
    A state that is neither set (a fresh one, a checkpoint's, a caller's)
    is first copied into the first. So a returned state stays valid until
    the block after the next one, and a caller that keeps the state from
    before a block can run the block again from it (the Session's retry).
    A block's outputs, all that the step returns before the state, live
    in the memory of its slot's graph, which the next replay of that
    graph overwrites: the caller gives each block it still holds a slot
    of its own. A replay that has run adds the launches its graph holds
    to their wrappers' ``launches`` counters, as the eager step would.
    """

    def __init__(self, slots: int, graphable: bool):
        self.slots = slots
        self.graphable = graphable
        self.last: str | None = None
        self._key = None
        self._graphs: dict = {}      # (slot, set read) -> _capture's
        self._sets: tuple = ()       # the two static state sets
        self._iq = None              # the static input
        self._tables: dict = {}      # the key's device tables (holding)

    def __call__(self, fn, iq, states, *, slot: int, **kw) -> tuple:
        def vec(x):
            return (tuple(np.asarray(x).ravel().tolist())
                    if isinstance(x, (list, np.ndarray)) else x)

        key = (fn, tuple((x.shape, x.dtype, x.device)
                         for x in tree_leaves(iq)),
               tuple(sorted((k, vec(v)) for k, v in kw.items())))
        if key != self._key:
            self._key = key
            self._graphs, self._sets, self._iq = {}, (), None
            self._tables = {}
        elif self.graphable and 0 <= slot < self.slots:
            return self._replay(fn, iq, self._source(states), slot, kw)
        self.last = "eager"
        with holding(self._tables):
            return fn(iq, states=states, **kw)

    def _source(self, states) -> int:
        """Which static set the step reads: the set ``states`` is, else
        the first, after ``states`` is copied into it."""
        if not self._sets:
            self._sets = tuple(tree_map(torch.empty_like, states)
                               for _ in range(2))
        for i, st in enumerate(self._sets):
            if states is st:
                return i
        _copy(self._sets[0], states)
        return 0

    def _replay(self, fn, iq, src: int, slot: int, kw: dict) -> tuple:
        if self._iq is None:
            self._iq = tree_map(lambda x: torch.empty(
                x.shape, dtype=x.dtype, device=x.device), iq)
        _copy(self._iq, iq)
        dst = self._sets[1 - src]
        entry = self._graphs.get((slot, src))
        new = entry is None
        if new:
            entry = self._capture(fn, self._sets[src], dst, kw)
            self._graphs[(slot, src)] = entry
        graph, out, launches = entry
        graph.replay()
        for w, n in launches.items():
            w.launches += n
        self.last = "capture" if new else "replay"
        return (*out, dst)

    def _capture(self, fn, src, dst, kw: dict):
        """A graph of the step from ``src`` and the static input, ending
        in copies of the new state into ``dst`` (nothing runs yet), its
        outputs (what the step returns before the state), and the
        launches of each registered wrapper in it (the counters are left
        as they were: a capture runs nothing).

        The garbage collector is off while the graph captures: a
        collection could free another graph (a dropped stage's, in a
        reference cycle), whose memory goes back to the card with a call
        that a capture forbids."""
        before = [w.launches for w in LAUNCH_COUNTERS]
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with holding(self._tables), torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
                *out, new = fn(self._iq, states=src, **kw)
                _copy(dst, new)
        finally:
            if collecting:
                gc.enable()
            launches = {w: w.launches - n for w, n
                        in zip(LAUNCH_COUNTERS, before) if w.launches != n}
            for w, n in launches.items():
                w.launches -= n
        return graph, tuple(out), launches
