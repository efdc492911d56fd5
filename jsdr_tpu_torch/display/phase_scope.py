"""Phase-scope reductions — the data half of phase.java: constellation
points (subsampled) and pixel-column-averaged I/Q time traces, autoscaled
to the block maximum (phase.java:43-121).

A copy of :mod:`jsdr_tpu.display.phase_scope` (it imports no jax),
numbers and behaviour unchanged; tests/test_torch_host_copies.py holds
it equal to the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class PhaseScopeData(NamedTuple):
    points: np.ndarray    # [width, 2] normalized constellation points
    i_trace: np.ndarray   # [width] column-averaged I
    q_trace: np.ndarray   # [width] column-averaged Q
    max_abs: float


def phase_scope_data(iq: np.ndarray, width: int = 512) -> PhaseScopeData:
    iq = np.asarray(iq)
    n = len(iq)
    m = float(np.max(np.abs(np.stack([iq.real, iq.imag])))) or 1.0
    cols = np.array_split(np.arange(n), width)
    pts = np.stack([[iq[c[0]].real / m, iq[c[0]].imag / m] for c in cols])
    i_trace = np.array([iq[c].real.mean() / m for c in cols])
    q_trace = np.array([iq[c].imag.mean() / m for c in cols])
    return PhaseScopeData(pts, i_trace, q_trace, m)
