"""Waterfall accumulation — the data half of waterfall.java.

Keeps a scrolling [height, width] uint8 intensity buffer; each PSD line
is max-decimated to the display width and mapped with the reference's
intensity law 255 - psd * -2.55 (clamped; waterfall.java:90-107). The
peak color multiply is left to the renderer. A copy of
:mod:`jsdr_tpu.display.waterfall` (numpy only).
"""

from __future__ import annotations

import numpy as np


def psd_to_line(psd: np.ndarray, width: int) -> np.ndarray:
    """Max-decimate one dBFS PSD line to ``width`` pixels and map to
    0..255 intensity, with the display's centered frequency order
    (0 Hz in the middle, waterfall.java:96-106)."""
    psd = np.asarray(psd)
    n = psd.shape[-1]
    step = n / width
    idx0 = (np.arange(width) * step).astype(int)
    idx1 = np.maximum(idx0 + max(int(step), 1), idx0 + 1)
    vals = np.stack([psd[a:b].max() for a, b in zip(idx0, np.minimum(idx1, n))])
    f = 255.0 - vals * -2.55
    line = np.clip(f, 0, 255).astype(np.uint8)
    return np.roll(line, width // 2)  # 0..+f/2..-f/2 -> centered


class Waterfall:
    def __init__(self, width: int = 1024, height: int = 512):
        self.width = width
        self.height = height
        self.buf = np.zeros((height, width), np.uint8)

    def push(self, psd: np.ndarray) -> None:
        """Scroll down one line, insert the new line at the top."""
        self.buf[1:] = self.buf[:-1]
        self.buf[0] = psd_to_line(psd, self.width)

    def push_many(self, psd_lines: np.ndarray) -> None:
        for line in np.atleast_2d(psd_lines):
            self.push(line)
