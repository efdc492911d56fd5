"""Batched FFT spectrum / PSD — the port of :mod:`jsdr_tpu.ops.spectrum`
(the replacement for fft.java).

The reference transforms each 0.1 s block and computes a dBFS PSD plus
the spectral maximum per block (fft.java:190-228). Here blocks are
batched [B, N] planar pairs (:mod:`jsdr_tpu_torch.ops.cplx`);
:func:`spectrum_block` transforms them with ``torch.fft``
(:func:`jsdr_tpu_torch.ops.mxu_fft.fft_cf`), and :func:`spectrum_wide`
runs the fused spectrum kernel over contiguous stream rows.

PSD convention (fft.java:197-207, after pysdr.org):
    psd = 10*log10((re^2 + im^2) * (2/N)^2)
Frequency convention for the argmax (fft.java:208-221): bin p maps to
+p*rate/N for p < N/2 and (p - N)*rate/N above.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .cplx import CF
from .mxu_fft import fft_cf
from .spectrum_fused import (MAX_N1, N2, spectrum_fused,
                             spectrum_natural_order)
from .windows import hamming

_EPS = 1e-30  # avoid log(0); reference happily takes -inf


def bin_to_hz(signed_bin: torch.Tensor, rate: int, n: int) -> torch.Tensor:
    """floor(signed_bin * rate / n) without int32 overflow.

    The naive ``signed * rate // n`` wraps for large transforms
    (n=192000 at 96 kS/s puts |bin*rate| ~ 2.4e9 past int32); reduce by
    gcd, then split the division: for a = q*n' + s (0 <= s < n'),
    floor(a*r'/n') = q*r' + floor(s*r'/n') — every product stays within
    int32 for any realistic rate/n pair. Keeps the reference's integer
    truncation convention (fft.java:215-220)."""
    g = math.gcd(int(rate), int(n))
    r, m = int(rate) // g, int(n) // g
    if m == 1:
        return signed_bin * r
    q = signed_bin // m
    s = signed_bin % m          # nonneg for positive m (floor semantics)
    return q * r + (s * r) // m


class SpectrumResult(NamedTuple):
    psd: torch.Tensor        # [..., N] dBFS
    peak_freq: torch.Tensor  # [...] Hz (signed)
    peak_db: torch.Tensor    # [...]


def psd_dbfs(spec: CF) -> torch.Tensor:
    """Planar spectrum -> dBFS PSD with the (2/N)^2 correction."""
    n = spec.shape[-1]
    cf = (2.0 / n) ** 2
    power = (spec.re * spec.re + spec.im * spec.im) * cf
    return 10.0 * torch.log10(torch.clamp_min(power, _EPS))


def spectrum_block(iq: CF, rate: float, window: bool = True) -> SpectrumResult:
    """Windowed FFT + PSD + peak search over [..., N] blocks.

    ``window=False`` reproduces the reference's quirk of computing but
    never applying the Hamming window (fft.java:71-73 vs :193)."""
    n = iq.shape[-1]
    if window:
        w = hamming(n, device=iq.re.device)
        iq = CF(iq.re * w, iq.im * w)
    psd = psd_dbfs(fft_cf(iq))
    p = torch.argmax(psd, dim=-1)        # the first maximum
    peak_db = psd.amax(dim=-1)
    signed = torch.where(p < n // 2, p, p - n)
    # integer truncation parity with fft.java:215-220 (int arithmetic)
    peak_freq = bin_to_hz(signed, int(rate), n)
    return SpectrumResult(psd, peak_freq.to(torch.int32), peak_db)


def spectrum_wide(iq: CF, n: int, rate: float, window: bool = True,
                  natural: bool = True) -> SpectrumResult:
    """Spectrum over contiguous [S, T] stream rows, n samples per block.

    Runs the fused spectrum kernel
    (:func:`jsdr_tpu_torch.ops.spectrum_fused.spectrum_fused`) when n fits
    it (n % 128 == 0 and n // 128 <= 512, the reference's rule), else
    reshape + :func:`spectrum_block`. Results have leading shape
    [S, T//n]. ``natural=False`` keeps the PSD in the kernel's permuted
    layout [T//n, S, n1, 128] (natural bin = n1*k2 + k1); peaks are
    always in natural (signed-Hz) convention."""
    s, t = iq.shape
    if t % n:
        raise ValueError(f"spectrum_wide: T = {t} is not a multiple of n = {n}")
    if n % N2 != 0 or n // N2 > MAX_N1:
        return spectrum_block(CF(iq.re.reshape(s, t // n, n),
                                 iq.im.reshape(s, t // n, n)),
                              rate=rate, window=window)
    psd_perm, peak_db, p = spectrum_fused(iq, n, window=window,
                                          with_peaks=True)
    n1 = n // N2
    k_nat = n1 * (p % N2) + p // N2
    signed = torch.where(k_nat < n // 2, k_nat, k_nat - n)
    peak_freq = bin_to_hz(signed, int(rate), n).to(torch.int32)
    psd = spectrum_natural_order(psd_perm) if natural else psd_perm
    return SpectrumResult(psd, peak_freq.T, peak_db.T)


def waterfall_intensity(psd: torch.Tensor) -> torch.Tensor:
    """Map dBFS PSD lines to 0..255 intensity as the waterfall display does
    (waterfall.java:90-107: 255 - psd * -2.55, clamped)."""
    f = 255.0 - psd * -2.55
    return torch.clamp(f, 0.0, 255.0).to(torch.uint8)


def psd_with_maxima(res: SpectrumResult) -> torch.Tensor:
    """Pack PSD lines in the reference's publish convention: the PSD
    followed by two trailing floats [peak_freq, peak_db]
    (fft.java:222-226, consumed by waterfall.java:28-36)."""
    extras = torch.stack([res.peak_freq.to(res.psd.dtype),
                          res.peak_db.to(res.psd.dtype)], dim=-1)
    return torch.cat([res.psd, extras], dim=-1)
