"""Logging + per-stage timing — the ILogger / nanoTime-span analog
(ILogger.java:4-6, JavaAudio.java:306-318, fft.java:174-178).

``StageTimers`` accumulates wall-time and sample counts per named stage
and reports samples/s — the framework's replacement for the reference's
verbose ns logs; pair with ``jax.profiler`` traces for device-side
detail.

A copy of :mod:`jsdr_tpu.runtime.log` (it imports no jax), numbers and behaviour
unchanged; tests/test_torch_host_copies.py holds it equal to the
reference.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from datetime import datetime
from typing import Optional


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


class StageTimers:
    def __init__(self):
        self._wall = defaultdict(float)
        self._samples = defaultdict(int)
        self._calls = defaultdict(int)

    @contextmanager
    def stage(self, name: str, samples: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._wall[name] += time.perf_counter() - t0
            self._samples[name] += samples
            self._calls[name] += 1

    def report(self) -> dict[str, dict]:
        out = {}
        for name, wall in self._wall.items():
            s = self._samples[name]
            out[name] = {
                "wall_s": round(wall, 4),
                "calls": self._calls[name],
                "samples": s,
                "samples_per_s": round(s / wall, 1) if wall > 0 and s else None,
            }
        return out

    def __str__(self):
        return " | ".join(
            f"{k}: {v['wall_s']}s"
            + (f" ({v['samples_per_s']:.3g} S/s)" if v["samples_per_s"] else "")
            for k, v in self.report().items())
