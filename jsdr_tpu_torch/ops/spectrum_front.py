"""Merged waterfall spectrum + tuner mix + decimating FIR over [S, T]
stream rows — the port of
``jsdr_tpu/ops/pallas_kernels.py::_spec_front_kernel`` (wrapper
``spectrum_front_fused``).

One read of the full-rate input feeds both consumers of the flagship
step: the display spectrum of :func:`jsdr_tpu_torch.ops.spectrum_fused.
spectrum_waterfall` and the telemetry front end of
:func:`jsdr_tpu_torch.ops.mix_decimate.mix_decimate`. The CUDA kernel
(``csrc/spec_front.cu``) shares its spectrum code with the former's
kernel and its mix + FIR code with the latter's, so its outputs equal
theirs bit for bit. :func:`spectrum_front_fused` launches it for CUDA
tensors (counting ``spectrum_front_fused.launches``) and runs
:func:`spectrum_front_ref` for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _build
from .cplx import CF
from .mix_decimate import N_TAPS, PERIOD, mix_decimate_ref
from .spectrum_fused import (N2, check_geometry, cuda_ranks, kernel_tables,
                             plan_ints, power_scale, spectrum_wf_ref,
                             wf_group_for)


def sf_geometry(n: int, m: int) -> tuple[int, int]:
    """The reference's merged-kernel grid geometry: (FFT blocks per grid
    step, decimated outputs per sub-chunk) — 4 blocks at 96 k, 2 at 192 k
    (sized for the TPU's VMEM). The CUDA kernel takes one FFT block per
    CTA and does not need it; ``bpsk_block_batch_spectrum`` keeps it as
    the reference's eligibility rule (T a multiple of blocks * n)."""
    return (4, 1280) if 4 * n <= 40_000 else (2, 640)


def spectrum_front_ref(iq: CF, n: int, cos_pat: torch.Tensor,
                       sin_pat: torch.Tensor, taps: torch.Tensor, m: int,
                       tail: CF, gain: float = 1.0, window: bool = True,
                       max_width: int = 2048):
    """Plain PyTorch version: :func:`spectrum_wf_ref` at the waterfall
    group plus :func:`mix_decimate_ref`."""
    wf, mx, idx = spectrum_wf_ref(iq, n, window, wf_group_for(n, max_width))
    ds, new_tail = mix_decimate_ref(iq, cos_pat, sin_pat, taps, m, tail, gain)
    return wf, mx, idx, ds, new_tail


def spectrum_front_fused(iq: CF, n: int, cos_pat: torch.Tensor,
                         sin_pat: torch.Tensor, taps: torch.Tensor, m: int,
                         tail: CF, gain: float = 1.0, window: bool = True,
                         max_width: int = 2048, cluster: bool = False):
    """Merged waterfall spectrum + tuner mix + decimating FIR.

    ``iq``: CF of float32 [S, T], T a multiple of n (n % 128 == 0) and n a
    multiple of m; ``cos_pat``/``sin_pat``: [S, 128] mix patterns;
    ``taps``: [27]; ``tail``: CF [S, 26] carried mixed-domain history.
    Returns (wf [T//n, S, G, 128] dB decimated lines — see
    ``spectrum_waterfall`` — peak_db [T//n, S], flat permuted argmax
    [T//n, S] int32, ds CF [S, T//m], new_tail CF [S, 26]). On a card a
    block takes one CTA up to n1 = 225 and a 4-CTA cluster above
    (``cluster`` as in :func:`.spectrum_fused.cuda_ranks`)."""
    s, t_len = iq.shape
    dev = iq.re.device
    q = wf_group_for(n, max_width)
    check_geometry("spectrum_front_fused", t_len, n, q)
    if n % m:
        raise ValueError(f"spectrum_front_fused: n = {n} is not a multiple "
                         f"of the decimation {m}")
    for name, x, shape in (("iq.re", iq.re, (s, t_len)),
                           ("iq.im", iq.im, (s, t_len)),
                           ("cos_pat", cos_pat, (s, PERIOD)),
                           ("sin_pat", sin_pat, (s, PERIOD)),
                           ("taps", taps, (N_TAPS,)),
                           ("tail.re", tail.re, (s, N_TAPS - 1)),
                           ("tail.im", tail.im, (s, N_TAPS - 1))):
        _build.check_tensor("spectrum_front_fused", name, x, shape,
                            torch.float32, dev)
    if dev.type == "cpu":
        return spectrum_front_ref(iq, n, cos_pat, sin_pat, taps, m, tail,
                                  gain, window, max_width)
    if dev.type != "cuda":
        raise ValueError(f"spectrum_front_fused: unsupported device {dev}")

    n1, nblk = n // N2, t_len // n
    wf = torch.empty((nblk, s, n1 // q, N2), dtype=torch.float32, device=dev)
    mx = torch.empty((nblk, s), dtype=torch.float32, device=dev)
    idx = torch.empty((nblk, s), dtype=torch.int32, device=dev)
    yr = torch.empty((s, t_len // m), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    tr = torch.empty((s, N_TAPS - 1), dtype=torch.float32, device=dev)
    ti = torch.empty_like(tr)
    lib = _build.kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.jsdr_spec_front(
            iq.re.data_ptr(), iq.im.data_ptr(), *kernel_tables(n, window, dev),
            cos_pat.data_ptr(), sin_pat.data_ptr(), taps.data_ptr(),
            tail.re.data_ptr(), tail.im.data_ptr(), wf.data_ptr(),
            mx.data_ptr(), idx.data_ptr(), yr.data_ptr(), yi.data_ptr(),
            tr.data_ptr(), ti.data_ptr(), s, t_len, n1, q, *plan_ints(n),
            power_scale(n), m, float(gain), cuda_ranks(n, cluster), stream)
    _build.check(code, "spectrum_front_fused")
    spectrum_front_fused.launches += 1
    return wf, mx, idx, CF(yr, yi), CF(tr, ti)


spectrum_front_fused.launches = 0


def static_smem_bytes(ranks: int = 1) -> int:
    """The compiled merged kernel's static shared memory (bytes) at
    ``ranks`` CTAs a block, on the card; ``spectrum_fused.STATIC_SMEM``
    must hold it."""
    import ctypes

    out = ctypes.c_int(0)
    _build.check(_build.kernels().jsdr_spec_front_static_smem(
        ranks, ctypes.byref(out)), "spec_front static shared memory")
    return out.value
