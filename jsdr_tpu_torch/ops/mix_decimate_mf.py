"""Fused tuner mix + decimating FIR + VCO mix + matched filter — the port of
``jsdr_tpu/ops/pallas_kernels.py::_mix_dec_mf_kernel`` (wrapper
``mix_decimate_mf``).

Kernel 1's contract (:mod:`jsdr_tpu_torch.ops.mix_decimate`), then the
1200 Hz VCO mix of the decimated stream by a per-stream [S, 128] pattern
(``bi = i*cos``, ``bq = q*sin``, FUNcubeBPSKDemod.java:515-516; decimated
sample k takes column k % 128, which is phase index (vco_idx + k) % 8),
then the 65-tap matched filter over the carried 64-sample vco-mixed
history. :func:`mix_decimate_mf` launches the CUDA kernel
(``csrc/mix_dec_mf.cu``), in which the decimated stream never reaches
device memory, for CUDA tensors, and runs :func:`mix_decimate_mf_ref`,
the unfused chain, for CPU tensors. :func:`_mix_dec_mf_walk` is the
kernel's walk (spans, sub-chunks, matched-filter passes, their layouts in
shared memory and carried halos) in plain PyTorch; only the tests call it.
"""

from __future__ import annotations

import torch

from . import _build
from .cplx import CF
from .fir import fir_apply_streaming
from .mix_decimate import (N_TAPS, PERIOD, THREADS, _fir_rows, _staged_fir,
                           mix_decimate_ref)

N_MF = 65
# csrc/mix_dec_mf.cu's walk: decimated samples a sub-chunk (at m = 10 and
# 20; other m shrink it as m grows), outputs a thread and a matched-filter
# pass, and the words of a bb row
SUB = THREADS
MF_R = 4
PASS = THREADS * MF_R
BB_COLS = 296


def mix_decimate_mf_ref(iq: CF, cos_pat: torch.Tensor, sin_pat: torch.Tensor,
                        taps: torch.Tensor, m: int, tail: CF,
                        vco_cos: torch.Tensor, vco_sin: torch.Tensor,
                        mf_taps: torch.Tensor, mf_tail: CF, gain: float):
    """Plain PyTorch version: the unfused chain — kernel 1's plain
    version, the VCO pattern tiled over the decimated block (the values
    of ``demod.bpsk._vco_mix``), and ``fir_apply_streaming`` (counterpart
    of the reference's non-Pallas branch, pallas_kernels.py:1033-1046)."""
    ds, new_tail = mix_decimate_ref(iq, cos_pat, sin_pat, taps, m, tail, gain)
    t_ds = ds.shape[-1]
    reps = -(-t_ds // PERIOD)
    bb = CF(ds.re * vco_cos.repeat(1, reps)[:, :t_ds],
            ds.im * vco_sin.repeat(1, reps)[:, :t_ds])
    mf, new_mf_tail = fir_apply_streaming(bb, mf_taps, mf_tail)
    return mf, new_tail, new_mf_tail


def _mix_dec_mf_walk(iq: CF, cos_pat: torch.Tensor, sin_pat: torch.Tensor,
                     taps: torch.Tensor, m: int, tail: CF,
                     vco_cos: torch.Tensor, vco_sin: torch.Tensor,
                     mf_taps: torch.Tensor, mf_tail: CF, gain: float,
                     span: int, sub: int = SUB):
    """The kernel's walk (``csrc/mix_dec_mf.cu``) in plain PyTorch, each
    value in :func:`mix_decimate_mf_ref`'s arithmetic, so the two agree
    bit for bit. A CTA takes the outputs [k_s, k_s + span) of a stream and
    computes the decimated samples from ds0 = k_s - 64 (0 for the first
    span, which starts from the carried mf tail) in sub-chunks of ``sub``:
    a sub-chunk's mixed input, with the 26 // m columns of FIR halo before
    it, is stored polyphase (sample j of it at row j % m, column j // m of
    rows (sub + 26 // m) | 1 words apart) and read back by tap; its
    samples, VCO-mixed, go to bb position 64 + k - k_m (row p % 4, column
    p // 4, rows BB_COLS apart). Every PASS samples (or at the span's end)
    the matched filter runs over positions [0, 64 + n) of bb, thread t
    forming the outputs at positions 64 + 4t .. 64 + 4t + 3; then bb's
    last 64 positions carry to its first 64. Returns what
    :func:`mix_decimate_mf` returns. Nothing on the main path calls it."""
    s, t_len = iq.shape
    n_out = t_len // m
    h = (N_TAPS - 1) // m
    wp = (sub + h) | 1
    dev = iq.re.device
    reps = -(-t_len // PERIOD)
    pats = (cos_pat.repeat(1, reps)[:, :t_len],
            sin_pat.repeat(1, reps)[:, :t_len])
    mixed = [iq.re * pats[0], iq.im * pats[1]]
    tails = (tail.re, tail.im)
    vreps = -(-n_out // PERIOD)
    vcos = (vco_cos.repeat(1, vreps)[:, :n_out],
            vco_sin.repeat(1, vreps)[:, :n_out])
    out = [torch.empty((s, n_out), dtype=torch.float32, device=dev)
           for _ in range(2)]
    new_mf = [mf_tail.re, mf_tail.im]

    def bb_word(p):
        return (p % MF_R) * BB_COLS + p // MF_R

    halo = torch.arange(N_MF - 1, device=dev)
    for k_s in range(0, n_out, span):
        k_e = min(k_s + span, n_out)
        ds0 = 0 if k_s == 0 else k_s - (N_MF - 1)
        bb = [torch.zeros((s, MF_R * BB_COLS), device=dev) for _ in range(2)]
        if k_s == 0:
            for b, src in zip(bb, new_mf):
                b[:, bb_word(halo)] = src
        for k_m in range(ds0, k_e, PASS):
            n_m = min(PASS, k_e - k_m)
            for k_c in range(k_m, k_m + n_m, sub):
                n = min(sub, k_m + n_m - k_c)
                k = k_c + torch.arange(n, device=dev)
                ys, _ = _staged_fir(mixed, tails, taps, m, gain, k_c, n, wp)
                at = bb_word(N_MF - 1 + k - k_m)
                for p in (0, 1):
                    bb[p][:, at] = ys[p] * vcos[p][:, k]
            pos = torch.arange(N_MF - 1 + n_m, device=dev)
            seq = [b[:, bb_word(pos)] for b in bb]
            # thread t, register u: the output at position 64 + 4t + u
            kk = (MF_R * torch.arange(-(-n_m // MF_R), device=dev)[:, None]
                  + torch.arange(MF_R, device=dev)[None, :]).reshape(-1)
            kk = kk[(kk < n_m) & (k_m + kk >= k_s)]
            for p in (0, 1):
                mf = _fir_rows(seq[p], mf_taps, 1, n_m)
                out[p][:, k_m + kk] = mf[:, kk]
            if k_m + n_m == n_out:
                new_mf = [q[:, n_m:n_m + N_MF - 1] for q in seq]
            if k_m + n_m < k_e:
                for b in bb:
                    b[:, bb_word(halo)] = b[:, bb_word(n_m + halo)]
    padded = [torch.cat([tails[p], mixed[p]], dim=1) for p in (0, 1)]
    return (CF(*out), CF(*(q[:, t_len:].contiguous() for q in padded)),
            CF(*(q.contiguous() for q in new_mf)))


@_build.counts_launches
def mix_decimate_mf(iq: CF, cos_pat: torch.Tensor, sin_pat: torch.Tensor,
                    taps: torch.Tensor, m: int, tail: CF,
                    vco_cos: torch.Tensor, vco_sin: torch.Tensor,
                    mf_taps: torch.Tensor, mf_tail: CF, gain: float):
    """Mix + decimate + VCO mix + matched filter over [S, T] stream rows.
    ``cos_pat``/``sin_pat``: [S, 128] tuner patterns; ``taps``: [27];
    ``tail``: CF [S, 26] carried mixed-domain history; ``vco_cos``/
    ``vco_sin``: [S, 128] VCO patterns; ``mf_taps``: [65]; ``mf_tail``: CF
    [S, 64] carried vco-mixed history; T % m == 0. Returns (mf CF
    [S, T//m], new_tail CF [S, 26], new_mf_tail CF [S, 64]).

    CPU tensors run :func:`mix_decimate_mf_ref`; CUDA tensors launch the
    kernel (and count the launch in ``mix_decimate_mf.launches``)."""
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
                           ("tail.im", tail.im, (s, N_TAPS - 1)),
                           ("vco_cos", vco_cos, (s, PERIOD)),
                           ("vco_sin", vco_sin, (s, PERIOD)),
                           ("mf_taps", mf_taps, (N_MF,)),
                           ("mf_tail.re", mf_tail.re, (s, N_MF - 1)),
                           ("mf_tail.im", mf_tail.im, (s, N_MF - 1))):
        _build.check_tensor("mix_decimate_mf", name, x, shape, torch.float32,
                            dev)
    if dev.type == "cpu":
        return mix_decimate_mf_ref(iq, cos_pat, sin_pat, taps, m, tail,
                                   vco_cos, vco_sin, mf_taps, mf_tail, gain)
    if dev.type != "cuda":
        raise ValueError(f"mix_decimate_mf: unsupported device {dev}")

    def empty(cols):
        return torch.empty((s, cols), dtype=torch.float32, device=dev)

    yr, yi = empty(t_len // m), empty(t_len // m)
    tr, ti = empty(N_TAPS - 1), empty(N_TAPS - 1)
    mr, mi = empty(N_MF - 1), empty(N_MF - 1)
    lib = _build.kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.jsdr_mix_dec_mf(
            iq.re.data_ptr(), iq.im.data_ptr(), cos_pat.data_ptr(),
            sin_pat.data_ptr(), taps.data_ptr(), tail.re.data_ptr(),
            tail.im.data_ptr(), vco_cos.data_ptr(), vco_sin.data_ptr(),
            mf_taps.data_ptr(), mf_tail.re.data_ptr(), mf_tail.im.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), tr.data_ptr(), ti.data_ptr(),
            mr.data_ptr(), mi.data_ptr(), s, t_len, m, float(gain), stream)
    _build.check(code, "mix_decimate_mf")
    mix_decimate_mf.launches += 1
    return CF(yr, yi), CF(tr, ti), CF(mr, mi)
