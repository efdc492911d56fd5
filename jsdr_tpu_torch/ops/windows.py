"""Window functions — the port of :mod:`jsdr_tpu.ops.windows`.

The reference computes a Hamming window but never applies it to the data
(fft.java:71-73 computes, :190-195 transforms raw data — the menu toggle
only changes a label). The framework applies windows for real; the
spectrum path keeps a compat flag to skip application when matching the
reference numerically.
"""

from __future__ import annotations

import numpy as np
import torch


def hamming_np(n: int) -> np.ndarray:
    """Host-side (numpy) Hamming with the reference's period-N convention,
    computed in float64 and rounded to float32 — the table the spectrum
    kernels read."""
    s = np.arange(n, dtype=np.float64)
    return (0.54 - 0.46 * np.cos(2 * np.pi * s / n)).astype(np.float32)


def hamming(n: int, dtype=torch.float32,
            device: torch.device | str = "cpu") -> torch.Tensor:
    """Hamming window with the reference's convention w[s] = 0.54 -
    0.46*cos(2*pi*s/N) (period N, not N-1; fft.java:72-73), computed in
    ``dtype`` on ``device``."""
    s = torch.arange(n, dtype=dtype, device=device)
    return (0.54 - 0.46 * torch.cos(2 * np.pi * s / n)).to(dtype)


def hamming_symmetric(n: int, dtype=torch.float32,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """Symmetric Hamming (period N-1) used by the FIR designer
    (demod.java:365, fir.java:188)."""
    s = torch.arange(n, dtype=dtype, device=device)
    return (0.54 - 0.46 * torch.cos(2 * np.pi * s / (n - 1))).to(dtype)
