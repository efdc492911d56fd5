"""Fused tuner mix + decimate-by-m FIR — the port of
``jsdr_tpu/ops/pallas_kernels.py::_mix_decimate_kernel`` (wrapper
``mix_decimate``).

Each stream's sample t is mixed with its 128-periodic quantized NCO
pattern (``i*cos[t%128]``, ``q*sin[t%128]``: the reference's non-complex
mix, FUNcubeBPSKDemod.java:389-390), prefixed with the carried 26-sample
MIXED-domain tail, and run through the 27-tap decimating FIR times
``gain``. :func:`mix_decimate` launches the CUDA kernel
(``csrc/mix_decimate.cu``) for CUDA tensors and runs
:func:`mix_decimate_ref` for CPU tensors. :func:`_mix_decimate_walk` is
the kernel's walk (``csrc/front_walk.cuh``: spans, sub-chunks, the
polyphase layout, the tail from the last sub-chunk) in plain PyTorch;
only the tests call it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .cplx import CF
from .fir import _fir_valid, polyphase_decimate

N_TAPS = 27
PERIOD = 128
# csrc/front_walk.cuh: threads a CTA (and outputs a sub-chunk at m = 10
# and 20), and input samples a thread stages a plane at run-time m
THREADS = 256
MAX_PER = 21


def mix_decimate_ref(iq: CF, cos_pat: torch.Tensor, sin_pat: torch.Tensor,
                     taps: torch.Tensor, m: int, tail: CF, gain: float):
    """Plain PyTorch version: tile the [S, 128] pattern over the block
    (the pattern phase is block-relative), mix, decimate (counterpart of
    ``_mix_decimate_ref``, pallas_kernels.py:578-590)."""
    t_len = iq.shape[-1]
    reps = -(-t_len // PERIOD)
    mixed = CF(iq.re * cos_pat.repeat(1, reps)[:, :t_len],
               iq.im * sin_pat.repeat(1, reps)[:, :t_len])
    return polyphase_decimate(mixed, taps, m, tail, gain)


def sub_chunk(m: int) -> int:
    """Outputs a sub-chunk of the kernel's walk at decimation m
    (``jsdr_walk::sub_chunk``): THREADS, halved (to 8 at least) while a
    thread would stage more than MAX_PER samples a plane; 0 where no
    sub-chunk fits (m > 672)."""
    sub = THREADS
    while sub > 8 and (sub + (N_TAPS - 1) // m) * m > MAX_PER * THREADS:
        sub //= 2
    return 0 if (sub + (N_TAPS - 1) // m) * m > MAX_PER * THREADS else sub


def _store_words(m: int, wp: int) -> np.ndarray:
    """The polyphase word of each staged sample j < MAX_PER * THREADS as
    the kernel's threads step to it at run-time m (``Stager::store``):
    thread tid's entry i holds j = tid + THREADS * i, starting at row
    tid % m, column tid // m, and each entry moves THREADS % m rows and
    THREADS // m columns on (a column more where the row wraps). At a
    fixed m the kernel computes (j % m) * wp + j // m."""
    tid = np.arange(THREADS)
    r, w = tid % m, (tid % m) * wp + tid // m
    dr = THREADS % m
    words = np.empty(MAX_PER * THREADS, np.int64)
    for i in range(MAX_PER):
        words[tid + THREADS * i] = w
        r, w = r + dr, w + dr * wp + THREADS // m
        wrap = r >= m
        r, w = np.where(wrap, r - m, r), np.where(wrap, w + 1 - m * wp, w)
    return words


def _tap_words(m: int, wp: int, stepped: bool) -> np.ndarray:
    """Word offsets (from the output's column) that FIR taps a = 0..26
    read in a staged sub-chunk (``fir_staged``): at a fixed m row
    (m-1-a) mod m, column h + floor((m-1-a) / m); at run-time m (stepped)
    one row back a tap from row m - 1, a column back where the row wraps."""
    h = (N_TAPS - 1) // m
    if not stepped:
        e = m - 1 - np.arange(N_TAPS)
        q = e % m
        return q * wp + h + (e - q) // m
    words, q, w = [], m - 1, (m - 1) * wp + h
    for _ in range(N_TAPS):
        words.append(w)
        q, w = (m - 1, w + (m - 1) * wp - 1) if q == 0 else (q - 1, w - wp)
    return np.array(words)


def _mix_decimate_walk(iq: CF, cos_pat: torch.Tensor, sin_pat: torch.Tensor,
                       taps: torch.Tensor, m: int, tail: CF, gain: float,
                       span: int, sub: int = THREADS):
    """The kernel's walk (``csrc/mix_decimate.cu`` on
    ``csrc/front_walk.cuh``) in plain PyTorch, each value in
    :func:`mix_decimate_ref`'s arithmetic, so the two agree bit for bit.
    A CTA takes the outputs [k_s, k_s + span) of a stream in sub-chunks of
    ``sub``: a sub-chunk's mixed input, with the 26 // m columns of FIR
    halo before it (the carried tail where t < 0), is stored at the words
    the kernel's threads step to (:func:`_store_words`; rows
    (sub + 26 // m) | 1 words apart) and its outputs read back from them.
    The new tail is read from the stream's last sub-chunk's buffer. Returns
    what :func:`mix_decimate` returns. Nothing on the main path calls it."""
    s, t_len = iq.shape
    n_out = t_len // m
    h = (N_TAPS - 1) // m
    wp = (sub + h) | 1
    dev = iq.re.device
    reps = -(-t_len // PERIOD)
    mixed = (iq.re * cos_pat.repeat(1, reps)[:, :t_len],
             iq.im * sin_pat.repeat(1, reps)[:, :t_len])
    tails = (tail.re, tail.im)
    out = [torch.empty((s, n_out), dtype=torch.float32, device=dev)
           for _ in range(2)]
    new_tail = [tail.re.clone(), tail.im.clone()]   # kept if n_out == 0
    for k_s in range(0, n_out, span):
        k_e = min(k_s + span, n_out)
        for k_c in range(k_s, k_e, sub):
            n = min(sub, k_e - k_c)
            ys, bufs = _staged_fir(mixed, tails, taps, m, gain, k_c, n, wp)
            for p in (0, 1):
                out[p][:, k_c:k_c + n] = ys[p]
            if k_c + n == n_out:         # input t_len - 26 .. t_len - 1
                j = (t_len - (N_TAPS - 1) + np.arange(N_TAPS - 1)
                     - (k_c - h) * m)
                tw = torch.from_numpy((j % m) * wp + j // m).to(dev)
                new_tail = [b[:, tw].contiguous() for b in bufs]
    return CF(*out), CF(*new_tail)


def _staged_fir(mixed, tails, taps: torch.Tensor, m: int, gain: float,
                k_c: int, n: int, wp: int):
    """One sub-chunk of the kernels' walk (``csrc/front_walk.cuh``): the
    mixed input samples t = (k_c - h) * m + j, j < (h + n) * m (the
    carried tail where t < 0), stored at the words the threads step to
    (:func:`_store_words`) of a polyphase buffer a plane, and the FIR
    outputs k_c .. k_c + n - 1 read back from them (times ``gain``).
    ``mixed``/``tails``: (re, im) planes. Returns (outputs, buffers), one a
    plane."""
    h = (N_TAPS - 1) // m
    dev = mixed[0].device
    t = (k_c - h) * m + torch.arange((h + n) * m, device=dev)
    word = torch.from_numpy(_store_words(m, wp)[:len(t)]).to(dev)
    first = (h + 1) * m - N_TAPS   # output k_c + i meets (i+h+1)*m - 1 - a
    ys, bufs = [], []
    for x, tl in zip(mixed, tails):
        buf = torch.zeros((x.shape[0], m * wp), device=dev)
        buf[:, word] = torch.where(
            t >= 0, x[:, t.clamp(min=0)],
            tl[:, (N_TAPS - 1 + t).clamp(0, N_TAPS - 2)])
        ys.append(_fir_rows(buf[:, word][:, first:], taps, m, n) * gain)
        bufs.append(buf)
    return ys, bufs


def _fir_rows(x: torch.Tensor, taps: torch.Tensor, stride: int, n: int):
    """The n outputs of ``fir._fir_valid`` over x, which holds exactly
    their window. A lone output is taken as the first of two: conv1d sums
    a single output in another order than a row of them."""
    if n == 1:
        x = torch.cat([x, torch.zeros_like(x[..., :stride])], dim=-1)
    return _fir_valid(x, taps, stride)[..., :n]


def mix_decimate(iq: CF, cos_pat: torch.Tensor, sin_pat: torch.Tensor,
                 taps: torch.Tensor, m: int, tail: CF, gain: float):
    """Mix + decimate over [S, T] stream rows. ``cos_pat``/``sin_pat``:
    [S, 128] per-stream mix patterns; ``taps``: [27]; ``tail``: CF
    [S, 26] carried mixed-domain history; T % m == 0. Returns
    (ds CF [S, T//m], new_tail CF [S, 26]).

    CPU tensors run :func:`mix_decimate_ref`; CUDA tensors launch the
    kernel (and count the launch in ``mix_decimate.launches``)."""
    s, t_len = iq.shape
    dev = iq.re.device
    if t_len % m:
        raise ValueError(f"block length {t_len} is not a multiple of the "
                         f"decimation {m}")
    for name, x, shape in (("iq.re", iq.re, (s, t_len)),
                           ("iq.im", iq.im, (s, t_len)),
                           ("cos_pat", cos_pat, (s, PERIOD)),
                           ("sin_pat", sin_pat, (s, PERIOD)),
                           ("taps", taps, (N_TAPS,)),
                           ("tail.re", tail.re, (s, N_TAPS - 1)),
                           ("tail.im", tail.im, (s, N_TAPS - 1))):
        _build.check_tensor("mix_decimate", name, x, shape, torch.float32,
                            dev)
    if dev.type == "cpu":
        return mix_decimate_ref(iq, cos_pat, sin_pat, taps, m, tail, gain)
    if dev.type != "cuda":
        raise ValueError(f"mix_decimate: unsupported device {dev}")

    n_out = t_len // m
    yr = torch.empty((s, n_out), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    tr = torch.empty((s, N_TAPS - 1), dtype=torch.float32, device=dev)
    ti = torch.empty_like(tr)
    lib = _build.kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.jsdr_mix_decimate(
            iq.re.data_ptr(), iq.im.data_ptr(), cos_pat.data_ptr(),
            sin_pat.data_ptr(), taps.data_ptr(), tail.re.data_ptr(),
            tail.im.data_ptr(), yr.data_ptr(), yi.data_ptr(), tr.data_ptr(),
            ti.data_ptr(), s, t_len, m, float(gain), stream)
    _build.check(code, "mix_decimate")
    mix_decimate.launches += 1
    return CF(yr, yi), CF(tr, ti)


mix_decimate.launches = 0
