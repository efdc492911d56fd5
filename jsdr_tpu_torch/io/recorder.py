"""Raw capture recorder — the recorder.java analog: append raw bytes (or
IQ converted back to S16LE) to a file for replay fixtures.

A copy of :mod:`jsdr_tpu.io.recorder` (it imports no jax), numbers and behaviour
unchanged; tests/test_torch_host_copies.py holds it equal to the
reference.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .convert import complex_to_s16le


class RawRecorder:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._fh = None

    def open(self):
        self._fh = open(self.path, "ab")
        return self

    def write_raw(self, raw: bytes):
        if self._fh:
            self._fh.write(raw)

    def write_iq(self, iq: np.ndarray):
        if self._fh:
            self._fh.write(complex_to_s16le(iq))

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self.open()

    def __exit__(self, *a):
        self.close()
