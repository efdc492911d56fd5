"""Fused tuner mix + decimate-by-m FIR — the port of
``jsdr_tpu/ops/pallas_kernels.py::_mix_decimate_kernel`` (wrapper
``mix_decimate``).

Each stream's sample t is mixed with its 128-periodic quantized NCO
pattern (``i*cos[t%128]``, ``q*sin[t%128]``: the reference's non-complex
mix, FUNcubeBPSKDemod.java:389-390), prefixed with the carried 26-sample
MIXED-domain tail, and run through the 27-tap decimating FIR times
``gain``. :func:`mix_decimate` launches the CUDA kernel
(``csrc/mix_decimate.cu``) for CUDA tensors and runs
:func:`mix_decimate_ref` for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _build
from .cplx import CF
from .fir import polyphase_decimate

N_TAPS = 27
PERIOD = 128


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
