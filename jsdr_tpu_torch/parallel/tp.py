"""Tensor-parallel FFT/PSD — the port of :mod:`jsdr_tpu.parallel.tp`:
ONE large DFT sharded over a mesh axis, as opposed to
``sharded_spectrum``'s pure data parallelism over independent blocks.

The decomposition N = N1*N2 turns the DFT into two dense contractions,
and TP shards the first one's reduction axis:

    stage 1: B[k1, n2] = sum_n1 W1[k1, n1] * A[n1, n2]
             -> each shard holds a contiguous time slice A[n1_loc, n2]
                (rows of A are contiguous in time) and computes a
                partial B; a psum_scatter over the axis sums the partials
                in rank order and leaves each shard its own k1 rows.
    twiddle: elementwise on the shard's [k1_loc, n2] slice.
    stage 2: D[k1_loc, k2] = C[k1_loc, n2] @ W2^T — local.

The output is sharded over k1, a strided-frequency sharding under the
final ordering X[N1*k2 + k1]; ``gather=True`` all-gathers and reorders to
natural ``np.fft`` order. The contractions are plain float32 matmuls over
the reference's host tables (``ops.mxu_fft._dft_mats``/``_twiddles``),
with TF32 off (``require_device``), as the reference computes them
outside any kernel.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.cplx import CF
from ..ops.mxu_fft import _MAX_FACTOR, _dft_mats, _twiddles
from ..ops.spectrum import bin_to_hz
from ..ops.windows import hamming_np
from .mesh import Mesh
from .sharded import _as_cf


@functools.lru_cache(maxsize=64)
def _tp_split(n: int, n_tp: int) -> Optional[Tuple[int, int]]:
    """Factor n = n1*n2 with n1 divisible by the TP degree (so both the
    time shards and the psum_scatter's k1 shards are equal), both parts
    <= the single-matmul cap. Prefers lane-aligned n2, then balance."""
    best, best_key = None, None
    for n1 in range(n_tp, _MAX_FACTOR + 1, n_tp):
        if n % n1 == 0:
            n2 = n // n1
            if n2 <= _MAX_FACTOR:
                key = (n2 % 128 == 0, n2 % 8 == 0, -abs(n1 - n2))
                if best_key is None or key > best_key:
                    best, best_key = (n1, n2), key
    return best


def tp_fft(mesh: Mesh, n: int, tp_axis: str = "sp", dp_axis: str = "dp",
           gather: bool = True, window: bool = False):
    """Build a tensor-parallel FFT over ``mesh``.

    Returns ``fn(x)`` for x [B, n] (CF or host complex): B rows of this
    process's dp shards, each row's time axis over ``tp_axis`` (on a mesh
    that spans processes along it, x holds this process's contiguous
    slice of each row). With ``gather=True`` the result is CF [B, n] in
    np.fft order; otherwise the stage output D[k1, k2] of this process's
    shards, CF [B, n1_loc * K, n2].

    ``window=True`` applies the Hamming window on the sharded time axis
    before the transform (each shard windows its own slice of the host
    table)."""
    n_tp = mesh.shape[tp_axis]
    split = _tp_split(n, n_tp)
    if split is None:
        raise ValueError(f"no TP split for n={n}, tp={n_tp}")
    n1, n2 = split
    n1_loc = n1 // n_tp
    lo, hi = mesh.local_range(tp_axis)
    k_loc = hi - lo
    dev = mesh.device

    def table(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    w1r_h, w1i_h = _dft_mats(n1, -1.0)       # [k1, n1]
    w2r, w2i = (table(w.T) for w in _dft_mats(n2, -1.0))   # [n2, k2]
    twr_h, twi_h = _twiddles(n1, n2, -1.0)   # [k1, n2]
    rows = slice(lo * n1_loc, hi * n1_loc)

    def by_shard(x):                         # [n1 or k1, ...] -> [K, 1, ...]
        return x.reshape(k_loc, n1_loc, *x.shape[1:])[:, None]

    # this process's columns of W1 (its time rows) and rows of the twiddle
    w1r = table(w1r_h[:, rows]).reshape(n1, k_loc, n1_loc).permute(1, 0, 2)
    w1i = table(w1i_h[:, rows]).reshape(n1, k_loc, n1_loc).permute(1, 0, 2)
    w1r, w1i = w1r[:, None], w1i[:, None]    # [K, 1, k1, n1_loc]
    twr, twi = by_shard(table(twr_h[rows])), by_shard(table(twi_h[rows]))
    win = by_shard(table(hamming_np(n).reshape(n1, n2)[rows]))

    def run(x) -> CF:
        x = _as_cf(x, dev)
        b = x.shape[0]
        if x.shape[1] != k_loc * n1_loc * n2:
            raise ValueError(f"tp_fft: rows of {x.shape[1]} samples, this "
                             f"process's slice is {k_loc * n1_loc * n2}")
        xr, xi = (v.reshape(b, k_loc, n1_loc, n2).transpose(0, 1)
                  for v in x)                # [K, B, n1_loc, n2]
        if window:
            xr, xi = xr * win, xi * win
        # stage 1 partial: each shard's rows of A against its W1 columns
        br = w1r @ xr - w1i @ xi             # [K, B, k1, n2]
        bi = w1r @ xi + w1i @ xr
        # reduce the partials and keep each shard's k1 rows
        br = _psum_scatter(mesh, br, tp_axis, k_loc, lo)
        bi = _psum_scatter(mesh, bi, tp_axis, k_loc, lo)
        cr = br * twr - bi * twi
        ci = br * twi + bi * twr
        # stage 2 (local): contract n2
        dr = cr @ w2r - ci @ w2i             # [K, B, k1_loc, k2]
        di = cr @ w2i + ci @ w2r
        if not gather:
            return CF(*(d.transpose(0, 1).reshape(b, k_loc * n1_loc, n2)
                        for d in (dr, di)))
        # all_gather k1 -> [B, k1, k2]; reorder X[N1*k2 + k1]
        return CF(*(mesh.all_gather(d, tp_axis).permute(1, 3, 0, 2)
                    .reshape(b, n) for d in (dr, di)))

    return run


def _psum_scatter(mesh: Mesh, x: torch.Tensor, axis: str, k_loc: int,
                  lo: int) -> torch.Tensor:
    """Sum the shards' [K, B, k1, n2] partials over ``axis`` and give
    each local shard its k1 rows: [K, B, k1 / n_axis, n2]."""
    full = mesh.psum(x, axis)                # [B, k1, n2]
    n_axis = mesh.shape[axis]
    k1_loc = full.shape[1] // n_axis
    return torch.stack([full[:, (lo + j) * k1_loc:(lo + j + 1) * k1_loc]
                        for j in range(k_loc)])


def tp_spectrum(mesh: Mesh, n: int, rate: float, tp_axis: str = "sp",
                dp_axis: str = "dp", window: bool = True):
    """PSD (dBFS) of one large windowed FFT per batch row, the transform
    itself sharded over ``tp_axis`` — the fft.java PSD formula
    (fft.java:197-207) at a size no single reference block could reach.
    Returns fn(x [B, n]) -> (psd_db [B, n], peak_freq [B] int32,
    peak_db [B]) with the reference's bin -> +/-Hz int truncation
    (fft.java:208-221)."""
    fft = tp_fft(mesh, n, tp_axis=tp_axis, dp_axis=dp_axis, gather=True,
                 window=window)
    scale2 = float(np.float32((2.0 / n) ** 2))

    def run(x):
        y = fft(x)
        p = (y.re * y.re + y.im * y.im) * scale2
        db = 10.0 * torch.log10(torch.clamp_min(p, 1e-30))
        k = torch.argmax(db, dim=-1)
        signed = torch.where(k < n // 2, k, k - n)
        freq = bin_to_hz(signed, int(rate), n).to(torch.int32)
        return db, freq, db.gather(1, k[:, None])[:, 0]

    return run
