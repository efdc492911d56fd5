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
the unfused chain, for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _build
from .cplx import CF
from .fir import fir_apply_streaming
from .mix_decimate import N_TAPS, PERIOD, mix_decimate_ref

N_MF = 65


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


mix_decimate_mf.launches = 0
