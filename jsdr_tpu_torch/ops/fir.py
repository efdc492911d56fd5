"""FIR design and application — the port of :mod:`jsdr_tpu.ops.fir`.

``bandpass_weights`` is the reference's windowed-sinc band-pass design
(demod.java:341-375, fir.java:166-195), in float64 numpy rounded to
float32, so the taps are bit-equal. ``fir_apply`` (zero prehistory),
``fir_apply_streaming`` (carried history) and ``polyphase_decimate`` are
one ``conv1d`` over ``[tail ++ x]`` (a strided one for the decimator), in
true float32: :func:`jsdr_tpu_torch.runtime.device.require_device` turns
cuDNN's TF32 off. ``fir_apply_fft`` is the whole-block frequency-domain
form over :func:`~jsdr_tpu_torch.ops.mxu_fft.fft_cf`. The reference runs
the same contractions as banded matmuls (bf16x3 or HIGHEST), so results
agree to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .cplx import CF


def bandpass_weights(ntaps: int, f_lo, f_hi, rate: float, *,
                     device: torch.device | str) -> torch.Tensor:
    """Windowed-sinc band-pass taps, Hamming windowed (demod.java:341-370),
    as float32 on ``device``.

    ``f_lo is None`` designs the all-pass (unit impulse at the centre tap,
    demod.java:343-347). Tap n multiplies the sample n steps in the past
    (the newest-first convention of the reference's delay loop, and of
    :func:`fir_apply_streaming`)."""
    if f_lo is None:
        w = np.zeros(ntaps)
        w[(ntaps - 1) // 2] = 1.0
    else:
        nlo = f_lo / rate
        nhi = f_hi / rate
        ord_ = ntaps - 1
        n = np.arange(ntaps)
        m = n - ord_ // 2
        with np.errstate(invalid="ignore", divide="ignore"):
            w = (np.sin(2 * np.pi * nhi * m)
                 - np.sin(2 * np.pi * nlo * m)) / (np.pi * m)
        w[ord_ // 2] = 2.0 * (nhi - nlo)
        w *= 0.54 - 0.46 * np.cos(2 * np.pi * n / ord_)
    return torch.as_tensor(w.astype(np.float32), device=device)


def _fir_valid(x: torch.Tensor, taps: torch.Tensor, stride: int = 1):
    """y[k] = sum_a x[..., k*stride + n-1-a] * taps[a] over the valid
    region (n = len(taps)); x: [..., L]."""
    w = taps.to(x.dtype).flip(0).reshape(1, 1, -1)
    y = F.conv1d(x.reshape(-1, 1, x.shape[-1]), w, stride=stride)
    return y.reshape(*x.shape[:-1], -1)


def _planes(x: CF) -> torch.Tensor:
    return torch.stack([x.re, x.im])


def _tail(xp: torch.Tensor, t_len: int) -> CF:
    """The carried history: the last n-1 samples of [tail ++ x]."""
    return CF(xp[0, ..., t_len:].contiguous(), xp[1, ..., t_len:].contiguous())


def fir_apply_streaming(x: CF, taps: torch.Tensor, tail: CF):
    """FIR over a block with carried history: y[t] = sum_a xp[t+n-1-a] *
    taps[a] with xp = [tail ++ x] and tail the previous n-1 samples.
    Returns (y CF [..., T], new_tail CF [..., n-1])."""
    xp = torch.cat([_planes(tail), _planes(x)], dim=-1)
    y = _fir_valid(xp, taps)
    return CF(y[0], y[1]), _tail(xp, x.shape[-1])


def polyphase_decimate(x: CF, taps: torch.Tensor, m: int, tail: CF,
                       gain: float = 1.0):
    """Decimate-by-m FIR evaluated at the kept instants only: output k =
    gain * sum_a xp[(k+1)m - 1 + n-1 - a] * taps[a] over xp = [tail ++ x]
    (FUNcubeBPSKDemod.java:470-492). x: [..., T] with T % m == 0.
    Returns (y CF [..., T//m], new_tail CF [..., n-1])."""
    t_len = x.shape[-1]
    if t_len % m:
        raise ValueError(f"block length {t_len} is not a multiple of the "
                         f"decimation {m}")
    xp = torch.cat([_planes(tail), _planes(x)], dim=-1)
    y = _fir_valid(xp[..., m - 1:], taps, stride=m) * gain
    return CF(y[0], y[1]), _tail(xp, t_len)


def fir_apply(x, taps: torch.Tensor):
    """FIR with zero prehistory: output aligned to input (y[t] uses
    x[t-ntaps+1..t], zeros before t=0). x: [..., T] real, complex or CF."""
    if isinstance(x, CF):
        return CF(fir_apply(x.re, taps), fir_apply(x.im, taps))
    if x.is_complex():
        return torch.complex(fir_apply(x.real, taps), fir_apply(x.imag, taps))
    return _fir_valid(F.pad(x, (taps.shape[0] - 1, 0)), taps)


def fir_apply_fft(x, taps: torch.Tensor):
    """Whole-block frequency-domain FIR (zero prehistory), within float32
    rounding of :func:`fir_apply`. x: [..., T] real tensor or CF; a real
    input gives a real output."""
    was_real = not isinstance(x, CF)
    xc = CF(x, torch.zeros_like(x)) if was_real else x
    from .mxu_fft import fft_cf, ifft_cf

    ntaps = taps.shape[0]
    t = xc.shape[-1]
    n = t + ntaps - 1
    spec = fft_cf(CF(F.pad(xc.re, (0, n - t)), F.pad(xc.im, (0, n - t))))
    h = F.pad(taps.to(torch.float32), (0, n - ntaps))
    hs = fft_cf(CF(h, torch.zeros_like(h)))
    y = ifft_cf(CF(spec.re * hs.re - spec.im * hs.im,
                   spec.re * hs.im + spec.im * hs.re))
    y = CF(y.re[..., :t], y.im[..., :t])
    return y.re if was_real else y
