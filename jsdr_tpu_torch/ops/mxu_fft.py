"""DFT tables and the planar FFT — the port of :mod:`jsdr_tpu.ops.mxu_fft`.

The reference runs every FFT as two dense matmuls plus a twiddle
(N = N1*N2 Cooley-Tukey) because its TPU compiler rejects complex HLO.
Here :func:`fft_cf` is ``torch.fft`` on the planar pair (it lies outside
any of the reference's Pallas kernels). The host tables :func:`_dft_mats`
and :func:`_twiddles` are kept exactly — float64 angles with the index
product reduced mod n, rounded to float32 — because the spectrum kernels
(``csrc/spectrum_body.cuh``) and their plain versions read them.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .cplx import CF


@functools.lru_cache(maxsize=32)
def _dft_mats(n: int, sign: float) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin DFT matrices W[k, t] = exp(sign*2pi*i*k*t/n), host f64->f32."""
    k = np.arange(n)[:, None]
    t = np.arange(n)[None, :]
    ang = sign * 2.0 * np.pi * (k * t % n) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _twiddles(n1: int, n2: int, sign: float) -> Tuple[np.ndarray, np.ndarray]:
    """W_N^(sign*k1*n2) as [n1, n2] cos/sin, host-exact."""
    n = n1 * n2
    k1 = np.arange(n1)[:, None]
    m2 = np.arange(n2)[None, :]
    ang = sign * 2.0 * np.pi * (k1 * m2 % n) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def fft_cf(x: CF, inverse: bool = False) -> CF:
    """DFT along the last axis of a CF pair (any leading batch dims).

    Forward matches ``np.fft.fft``; inverse matches ``np.fft.ifft``
    (including the 1/N scale)."""
    z = torch.complex(x.re, x.im)
    y = torch.fft.ifft(z) if inverse else torch.fft.fft(z)
    return CF(y.real.contiguous(), y.imag.contiguous())


def ifft_cf(x: CF) -> CF:
    return fft_cf(x, inverse=True)
