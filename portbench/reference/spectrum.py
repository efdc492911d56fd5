"""Plain reference of the display spectrum (fft.java, waterfall.java), for
the benchmark's ``correct``: per 0.1 s sub-block of n = rate / 10 samples
of a raw S16LE block, the Hamming window 0.54 - 0.46 cos(2 pi s / n)
(period n, fft.java:72-73), the DFT, the power |X|^2 (2 / n)^2 and its dB
10 log10(max(p, 1e-30)); the waterfall's pixels are the maximum dB over
groups of consecutive bins (``width`` groups in the Session's spectrum
stage, groups of ``q`` bins in the merged telemetry stage) and a line's
8-bit intensity is 255 - dB * -2.55, clipped to [0, 255] and truncated,
the line rolled by width / 2 (waterfall.java:90-107).

In float64 for the reference. The control (bfloat16) rounds the windowed
input, the transform's output and every later value to bfloat16; the
transform itself runs in float32, as torch has no bfloat16 FFT.
"""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-30


def block_iq(raw: np.ndarray, device) -> torch.Tensor:
    """Raw interleaved int16 values -> complex128 samples / 32767."""
    iq = torch.as_tensor(np.asarray(raw, np.int16).reshape(-1, 2).astype(
        np.float64), device=device) / 32767.0
    return torch.complex(iq[:, 0], iq[:, 1])


def psd_db(raw: np.ndarray, n: int, device, dtype=torch.float64,
           window: bool = True) -> torch.Tensor:
    """[sub-blocks, n] dB PSD of every n-sample sub-block, natural bin
    order (bin k is k * rate / n Hz, the upper half negative)."""
    x = block_iq(raw, device)
    x = x[:(x.shape[0] // n) * n].reshape(-1, n)
    if window:
        s = torch.arange(n, dtype=torch.float64, device=x.device)
        x = x * (0.54 - 0.46 * torch.cos(2 * np.pi * s / n))
    scale = (2.0 / n) ** 2
    if dtype == torch.float64:
        spec = torch.fft.fft(x)
        power = spec.real ** 2 + spec.imag ** 2
        return 10.0 * torch.log10(torch.clamp_min(power * scale, EPS))
    xr, xi = x.real.to(dtype), x.imag.to(dtype)
    spec = torch.fft.fft(torch.complex(xr.float(), xi.float()))
    sr, si = spec.real.to(dtype), spec.imag.to(dtype)
    power = ((sr * sr).to(dtype) + (si * si).to(dtype)).to(dtype)
    power = (power * scale).to(dtype)
    return (10.0 * torch.log10(torch.clamp_min(power.float(), EPS))).to(
        dtype).double()


def group_max(db: torch.Tensor, groups: int) -> torch.Tensor:
    """The maximum over each of ``groups`` runs of consecutive bins."""
    return db.reshape(*db.shape[:-1], groups, -1).amax(dim=-1)


def line_intensity(db: torch.Tensor, width: int) -> torch.Tensor:
    """The waterfall line's intensity before it is truncated to 8 bits,
    rolled by width / 2 as the line is (float64)."""
    inten = torch.clamp(255.0 + 2.55 * group_max(db, width), 0.0, 255.0)
    return torch.roll(inten, width // 2, dims=-1)


def db_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest dB gap between ``got`` and ``ref`` over the bins of each
    row at or above the row's median (the noise floor and what stands on
    it): bins far below the floor hold a float32 transform's rounding of
    the whole block's energy, not their own."""
    got, ref = got.double(), ref.double()
    med = ref.median(dim=-1, keepdim=True).values
    d = (got - ref).abs()
    return float(d[ref >= med].max())


def u8_gap(got: torch.Tensor, inten: torch.Tensor) -> float:
    """How far the reference's intensity lies outside each 8-bit value's
    interval [v, v + 1) (v = 255 takes everything from 255 up): 0 where
    the truncation of the reference gives the same value."""
    got = got.double()
    below = (got - inten).clamp(min=0)
    above = (inten - (got + 1)).clamp(min=0)
    above = torch.where(got >= 255, torch.zeros_like(above), above)
    return float(torch.maximum(below, above).max())
