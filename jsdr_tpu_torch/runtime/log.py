"""Logging and the port's tracer — the ILogger / nanoTime-span analog
(ILogger.java:4-6, JavaAudio.java:306-318, fft.java:174-178).

``Logger`` is a copy of :mod:`jsdr_tpu.runtime.log`'s (it imports no jax),
held equal to the reference by tests/test_torch_host_copies.py.

``StageTimers`` is the reference's per-stage timer grown into the port's
one tracer:

- per stage name, the summed wall, calls and samples (``stage``,
  ``report``), always on, as the reference keeps them;
- counters (``count``, ``counters``), always on: plain integer adds;
- spans, recorded only while ``spans_on``: ``(name, block, parent, t0_ns,
  t1_ns)`` on ``time.perf_counter_ns()``, ``parent`` the name of the span
  open around it, in a ring of fixed size (``RING``), so a station that
  streams for days holds a bounded amount. With spans off ``span`` returns
  one shared no-op context.

While torch's profiler records (checked once a block, in
``begin_block``), each span also opens a profiler range
``jsdr.<name>``; no range is ever opened while no profiler records. The
first profiled block also emits one range ``jsdr.clock`` whose
``perf_counter_ns`` reading the tracer keeps (``clock_ns``): the
``jsdr.clock`` event's ``ts`` in the profiler's trace, less ``clock_ns``,
maps every span of the ring onto the trace's clock.

The Session registers its tracer as the process's latest (``latest()``);
it holds host numbers only, so it outlives the Session.
"""

from __future__ import annotations

import json
import os
import sys
import time
from collections import defaultdict
from contextlib import nullcontext
from datetime import datetime
from typing import Optional

import torch


class Logger:
    """3-level logger: log (debug, gated), status, alert."""

    def __init__(self, verbose: bool = False, stream=None):
        self.verbose = verbose
        self.stream = stream or sys.stderr

    def _emit(self, level: str, msg: str):
        ts = datetime.now().strftime("%H:%M:%S.%f")[:-3]
        print(f"{ts} [{level}] {msg}", file=self.stream, flush=True)

    def log(self, msg: str):
        if self.verbose:
            self._emit("dbg", msg)

    def status(self, msg: str):
        self._emit("sts", msg)

    def alert(self, msg: str):
        self._emit("ALT", msg)


_NO_SPAN = nullcontext()
_latest: Optional["StageTimers"] = None


def latest() -> Optional["StageTimers"]:
    """The tracer of the process's latest ``Session.run``, or None."""
    return _latest


def set_latest(tracer: "StageTimers") -> None:
    global _latest
    _latest = tracer


class _Span:
    """One open span; with ``stage`` it also adds to the stage sums."""

    __slots__ = ("tr", "name", "samples", "stage", "on", "rf", "t0")

    def __init__(self, tr: "StageTimers", name: str, samples: int,
                 stage: bool):
        self.tr, self.name, self.samples, self.stage = tr, name, samples, stage
        self.rf = None

    def __enter__(self):
        tr = self.tr
        self.on = tr.spans_on
        self.t0 = time.perf_counter_ns()
        if self.on:
            tr._open.append(self.name)
            if tr._profiling:
                self.rf = torch.profiler.record_function("jsdr." + self.name)
                self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        tr = self.tr
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t1 = time.perf_counter_ns()
        if self.stage:
            tr._wall[self.name] += t1 - self.t0
            tr._samples[self.name] += self.samples
            tr._calls[self.name] += 1
        if self.on:
            tr._open.pop()
            tr._add(self.name, self.t0, t1)
        return False


class StageTimers:
    RING = 65536

    def __init__(self, spans: bool = False):
        self._wall = defaultdict(int)          # ns
        self._samples = defaultdict(int)
        self._calls = defaultdict(int)
        self.counters: dict[str, int] = defaultdict(int)
        self.spans_on = spans
        self.block = -1
        self.clock_ns: Optional[int] = None
        self._ring: list = []
        self._n = 0
        self._open: list[str] = []
        self._profiling = False

    def stage(self, name: str, samples: int = 0) -> _Span:
        """Time a stage call: summed always, a span while spans are on."""
        return _Span(self, name, samples, True)

    def span(self, name: str):
        """A nested span (no stage sums); a shared no-op when off."""
        if not self.spans_on:
            return _NO_SPAN
        return _Span(self, name, 0, False)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def begin_block(self, block: int) -> None:
        """Set the block index of the spans that follow, and look once
        whether torch's profiler records (spans on only)."""
        self.block = block
        self._profiling = (self.spans_on
                           and torch.autograd._profiler_enabled())
        if self._profiling and self.clock_ns is None:
            rf = torch.profiler.record_function("jsdr.clock")
            self.clock_ns = time.perf_counter_ns()
            with rf:
                pass

    def _add(self, name: str, t0: int, t1: int) -> None:
        rec = (name, self.block, self._open[-1] if self._open else None,
               t0, t1)
        if len(self._ring) < self.RING:
            self._ring.append(rec)
        else:
            self._ring[self._n % self.RING] = rec
        self._n += 1

    def spans(self) -> list[tuple]:
        """The spans the ring holds, oldest first: (name, block, parent,
        t0_ns, t1_ns)."""
        i = self._n % len(self._ring) if self._ring else 0
        return self._ring[i:] + self._ring[:i]

    def report(self) -> dict[str, dict]:
        return {name: {"wall_s": round(wall / 1e9, 4),
                       "calls": self._calls[name],
                       "samples": self._samples[name]}
                for name, wall in self._wall.items()}

    def write_chrome_trace(self, path) -> None:
        """The spans as Chrome trace JSON on the host clock (µs of
        ``perf_counter``; Perfetto opens it), the counters as a counter
        event at the end and under ``otherData``."""
        pid = os.getpid()
        events = [{"name": name, "ph": "X", "ts": t0 / 1e3,
                   "dur": (t1 - t0) / 1e3, "pid": pid, "tid": 0,
                   "args": {"block": block, "parent": parent}}
                  for name, block, parent, t0, t1 in self.spans()]
        counters = dict(self.counters)
        events.append({"name": "counters", "ph": "C", "pid": pid, "tid": 0,
                       "ts": time.perf_counter_ns() / 1e3,
                       "args": counters})
        with open(path, "w") as fh:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "otherData": {"counters": counters}}, fh)
