"""FFT auto-tune front end — the port of :mod:`jsdr_tpu.demod.fft_tuner`,
the ``doBufferFFT`` path of the reference (FUNcubeBPSKDemod.java:399-464).

Per 0.1 s block: forward FFT, box-averaged PSD peak search in the lower
(or upper, ``track_high``) half-band with EMA-tracked peak power, centre
bin clamped >= 102, then a 204-bin slice around the peak is inverse-
transformed and ONLY ITS REAL PART feeds the decimator (the reference
drops Q — a quirk of its C++ heritage, :462).

The computation is split by data dependence, as in the reference, and
batched over streams ([S] leading axis everywhere):

- :func:`tuner_precompute`: per-block FFT (``torch.fft``), box-summed PSD
  (a float32 running sum with clamped edges, in the reference's order of
  additions) and the masked first-max peak search — parallel over streams
  and blocks;
- :func:`tuner_recurrence`: the (avePeakPower, aveCentreBin, centreBin)
  chain, vectorised over streams and serial over blocks (10 steps a 1 s
  block), ``ave[centre]`` read by direct indexing;
- :func:`tuner_emit`: the slice ``[centre-102, centre+102)`` by direct
  indexing, then the zero-padded inverse transform as ONE true-float32
  matmul against the reference's constant ``[204, samples]`` iDFT tables
  (built the same way, in float64, rounded to float32).

The reference reaches the same values through gather-free forms (one-hot
matmuls, a 7-step roll); only the values are the contract.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops.cplx import CF
from ..ops.mxu_fft import fft_cf

# FUNcubeBPSKDemod.java:399-402; copied from jsdr_tpu/demod/fft_tuner.py
# (that module imports jax); tests/test_torch_constants.py holds them equal
PSD_AVG = 2.0 / (10 + 1)
PSD_INV = 1.0 - PSD_AVG
SLICE_HALF = 102          # bins copied around the peak (:458)
BOX_HALF = 50             # box-average half width (:435)
EDGE = 75                 # peak-search guard band (:433)
MIN_CENTRE = 102          # clamp (:453)


class FftTunerState(NamedTuple):
    """Auto-tune EMA state, the fields of the reference's
    ``FftTunerState`` in its order, one entry per stream."""
    ave_peak_power: torch.Tensor  # [S] f32
    ave_centre_bin: torch.Tensor  # [S] f32
    centre_bin: torch.Tensor      # [S] i32


def fft_tuner_init(n_streams: int, device) -> FftTunerState:
    """Fresh tuner state for ``n_streams`` streams on ``device``."""
    def z(dtype):
        return torch.zeros(n_streams, dtype=dtype, device=device)
    return FftTunerState(z(torch.float32), z(torch.float32), z(torch.int32))


def tuner_precompute(iq_blocks: CF, track_high: torch.Tensor):
    """Stateless per-block analysis (parallel over streams and blocks).

    iq_blocks: CF [S, n_blocks, samples]; track_high: [S] bool. Returns
    (spec CF [S, n_blocks, samples], ave [S, n_blocks, samples//2] box-
    summed PSD, bin_pos [S, n_blocks] i64, max_bin [S, n_blocks] f32,
    end [S] i64 — the half-band end used for the centre clamp)."""
    samples = iq_blocks.shape[-1]
    half = samples // 2
    dev = iq_blocks.re.device
    spec = fft_cf(iq_blocks)
    sr, si = spec.re[..., :half], spec.im[..., :half]
    psd = torch.sqrt(sr * sr + si * si)

    # the search half-band is per-stream data (FUNcube<n>-bpsk-upper,
    # FUNcubeBPSKDemod.java:97-99)
    th = track_high.to(torch.bool)
    beg = torch.where(th, samples // 4, 0)
    end = torch.where(th, samples // 2, samples // 4)
    # the reference's float32 running sum, addition for addition: past a
    # strong peak the small bins no longer move it, which is what puts a
    # pure tone's plateau maximum at its left edge (the first-max rule)
    csum = _cumsum_blocked(torch.cat([torch.zeros_like(psd[..., :1]), psd],
                                     dim=-1))
    i = torch.arange(half, device=dev)
    ave = (csum[..., torch.clamp(i + BOX_HALF, max=half)]
           - csum[..., torch.clamp(i - BOX_HALF, min=0)])
    in_range = ((i >= (beg + EDGE)[:, None, None])
                & (i < (end - EDGE)[:, None, None]))
    masked = torch.where(in_range, ave, -torch.inf)
    max_bin, bin_pos = torch.max(masked, dim=-1)     # the first maximum
    return spec, ave, bin_pos, max_bin, end


def _cumsum_blocked(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    """Inclusive float32 cumsum along the last axis in the order of XLA's
    CPU rewrite of the reference's ``jnp.cumsum`` (a reduce-window scan):
    sequential sums within blocks of ``base``, the block totals scanned
    the same way, then each block's carry added — so every partial sum
    is the reference's, bit for bit, on the CPU and on the card."""
    n = x.shape[-1]
    if n <= base:
        y = x.clone()
        for k in range(1, n):
            y[..., k] += y[..., k - 1]
        return y
    nb = -(-n // base)
    y = torch.nn.functional.pad(x, (0, nb * base - n))
    y = y.reshape(*x.shape[:-1], nb, base).clone()
    for k in range(1, base):
        y[..., k] += y[..., k - 1]
    tot = _cumsum_blocked(y[..., -1].contiguous(), base)
    y[..., 1:, :] += tot[..., :-1, None]
    return y.reshape(*x.shape[:-1], nb * base)[..., :n]


def _ema(at: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """PSD_AVG * at + PSD_INV * prev in float32 as the reference's CPU
    build evaluates it: one fused multiply-add, fma(PSD_AVG, at,
    PSD_INV * prev) (float64 holds the product exactly)."""
    rest = (PSD_INV * prev).double()
    return (float(np.float32(PSD_AVG)) * at.double() + rest).float()


def tuner_recurrence(state: FftTunerState, ave: torch.Tensor,
                     bin_pos: torch.Tensor, max_bin: torch.Tensor,
                     end: torch.Tensor
                     ) -> Tuple[FftTunerState, torch.Tensor]:
    """The sequential EMA/centre chain over blocks, all streams at once.

    ave [S, n_blocks, samples//2], bin_pos/max_bin [S, n_blocks], end
    [S]. Returns (new state, centres [S, n_blocks] i64), the per-block
    centre bins that place the slices."""
    app, acb, cb = state
    cb = cb.long()
    centres = []
    for b in range(ave.shape[1]):
        centre = torch.minimum(torch.clamp(cb, min=0), end - 1)
        at = ave[:, b].gather(1, centre[:, None])[:, 0]
        app = _ema(at, app)
        pos = bin_pos[:, b]
        take = (max_bin[:, b] > app * 1.25) & (pos > 0)
        acb = torch.where(take, pos.to(torch.float32), acb)
        cb = torch.where(take, (acb + 1.0).long(), centre)
        cb = torch.clamp(cb, min=MIN_CENTRE)
        centres.append(cb)
    new = FftTunerState(app, acb, cb.to(torch.int32))
    return new, torch.stack(centres, dim=1)


@functools.lru_cache(maxsize=8)
def _idft_slice_mats(samples: int, device: torch.device) -> torch.Tensor:
    """The reference's constant iDFT of a spectrum that is zero outside
    bins 0..203 (host float64, rounded to float32), stacked as
    [cos; -sin]: [2*204, samples], so the real part of the inverse
    transform of a slice (re, im) is one matmul of [re, im] against it."""
    k = np.arange(2 * SLICE_HALF)[:, None]
    t = np.arange(samples)[None, :]
    ang = 2.0 * np.pi * (k * t % samples) / samples
    cos = np.cos(ang).astype(np.float32) / samples
    sin = np.sin(ang).astype(np.float32) / samples
    return torch.as_tensor(np.concatenate([cos, -sin]), device=device)


def tuner_emit(spec: CF, centres: torch.Tensor) -> CF:
    """Slice [centre-102, centre+102) -> inverse transform -> real-only
    feed (parallel over streams and blocks). spec CF [S, n_blocks,
    samples], centres [S, n_blocks]. Returns the feed CF [S, n_blocks,
    samples] with I = Q = re (the Q-drop quirk, :461-463)."""
    samples = spec.shape[-1]
    out_len = 2 * SLICE_HALF
    start = torch.clamp(centres.long() - SLICE_HALF, 0, samples - out_len)
    idx = start[..., None] + torch.arange(out_len, device=start.device)
    sl = torch.cat([spec.re.gather(-1, idx), spec.im.gather(-1, idx)], -1)
    feed = sl @ _idft_slice_mats(samples, sl.device)
    return CF(feed, feed)


def fft_tuner_blocks(iq_blocks: CF, state: FftTunerState,
                     track_high: torch.Tensor
                     ) -> Tuple[CF, torch.Tensor, FftTunerState]:
    """Auto-tune each stream's sequence of 0.1 s blocks.

    iq_blocks: CF [S, n_blocks, samples]; state: [S] leaves; track_high:
    [S] bool. Returns (feed CF [S, n_blocks*samples] with I = Q = the
    real part, centre bins [S, n_blocks] i32, new state)."""
    spec, ave, bin_pos, max_bin, end = tuner_precompute(iq_blocks,
                                                        track_high)
    new_state, centres = tuner_recurrence(state, ave, bin_pos, max_bin, end)
    feed = tuner_emit(spec, centres)
    s = feed.re.shape[0]
    flat = feed.re.reshape(s, -1)
    return CF(flat, flat), centres.to(torch.int32), new_state
