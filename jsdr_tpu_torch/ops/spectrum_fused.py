"""Fused window + two-stage DFT + PSD (+ waterfall decimation and peak) over
contiguous [S, T] stream rows — the port of
``jsdr_tpu/ops/pallas_kernels.py::_spectrum_wf_kernel`` (wrappers
``spectrum_fused`` and ``spectrum_waterfall``).

For each n-sample block (n = n1 * 128) of each stream: Hamming window,
the two-stage DFT (an n1-point DFT down the columns of the block as
[n1, 128], a twiddle, a 128-point DFT along the rows), power
|D|^2 * (2/n)^2, dB, the max over q consecutive k1, and the block's
peak. Outputs keep the reference's layouts: wf ``[T//n, S, n1//q, 128]``
in PERMUTED order (element ``[.., k1, k2]`` is natural bin ``n1*k2 + k1``
for q = 1; for q > 1, pixel ``(n1//q)*k2 + g`` covers q consecutive
natural bins), peak dB ``[T//n, S]`` and the flat permuted argmax
``[T//n, S]`` int32 (the first maximum in the order ``k1*128 + k2``).

:func:`spectrum_fused` (q = 1, the full PSD) and
:func:`spectrum_waterfall` (q = :func:`wf_group_for`) launch the CUDA
kernel (``csrc/spectrum_wf.cu``) for CUDA tensors, counting each launch
in ``spectrum_fused.launches``, and run :func:`spectrum_wf_ref` for CPU
tensors. The kernel computes the transform as a factored FFT planned by
:mod:`.fft_plan`; :func:`spectrum_fft_ref` is the plain mirror of its pass
order, which only the tests call. All are fp32 throughout; the
reference's ``precision`` (bf16x3 or HIGHEST MXU passes) and
``interpret`` arguments have no counterpart.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .cplx import CF
from .fft_plan import fft_block, fft_plan, plan_tables
from .mxu_fft import _dft_mats, _twiddles
from .windows import hamming_np

N2 = 128
MAX_N1 = 512        # the reference's rule: n // 128 <= 512
SMEM_PER_CTA = 232_448   # the shared memory a CTA may use on Hopper
# the merged kernel's static shared arrays (csrc/spec_front.cu: taps,
# pattern and halo, 1,340 bytes; the body's peak reduction, 64), rounded
# up to 16; chip_smoke.py holds the compiled kernel's figure to it
STATIC_SMEM = 1408
CLUSTER = 4         # CTAs a block above ONE_CTA_MAX_N1 (32 columns each)


def smem_bytes(n1: int, ranks: int = 1) -> int:
    """The dynamic shared memory of one spectrum CTA: its columns of the
    block's two float32 planes, 8 bytes a sample
    (csrc/spectrum_body.cuh::smem_bytes)."""
    return 8 * N2 * n1 // ranks


# The largest n1 one CTA holds beside the merged kernel's static arrays
# (225: n <= 28,800); above it a cluster of CLUSTER CTAs holds the block,
# each CTA 32 columns of every row (128 KB at n1 = MAX_N1)
ONE_CTA_MAX_N1 = (SMEM_PER_CTA - STATIC_SMEM) // smem_bytes(1)


def cuda_ranks(n: int, cluster: bool = False) -> int:
    """CTAs per FFT block on the card: 1 up to ``ONE_CTA_MAX_N1``, else a
    cluster of ``CLUSTER``. ``cluster=True`` takes the cluster at any n1:
    only the tests and chip_smoke.py ask for it, to compare the two
    layouts on the card."""
    return CLUSTER if cluster or n // N2 > ONE_CTA_MAX_N1 else 1


_EPS = 1e-30


class SpecTables(NamedTuple):
    """float32 device tables: the window and TW, which the kernels and the
    plain versions read, and the DFT matrices of :func:`spectrum_wf_ref`."""
    win: torch.Tensor   # [n]
    w1r: torch.Tensor   # [n1, n1] _dft_mats(n1, -1)
    w1i: torch.Tensor
    twr: torch.Tensor   # [n1, 128] _twiddles(n1, 128, -1)
    twi: torch.Tensor
    w2r: torch.Tensor   # [128, 128] _dft_mats(128, -1)
    w2i: torch.Tensor


@functools.lru_cache(maxsize=16)
def _tables_on(n: int, window: bool, device: str) -> SpecTables:
    n1 = n // N2
    win = hamming_np(n) if window else np.ones(n, np.float32)
    host = (win, *_dft_mats(n1, -1.0), *_twiddles(n1, N2, -1.0),
            *_dft_mats(N2, -1.0))
    return SpecTables(*(torch.as_tensor(np.ascontiguousarray(a),
                                        device=device) for a in host))


def spec_tables(n: int, window: bool, device: torch.device) -> SpecTables:
    """The tables for block size ``n`` on ``device`` (built once)."""
    return _tables_on(n, bool(window), str(torch.device(device)))


def kernel_tables(n: int, window: bool, device: torch.device):
    """The device pointers a spectrum kernel takes after its input planes:
    the window, the FFT plan's tables, and TW."""
    tb = spec_tables(n, window, device)
    return (tb.win.data_ptr(),
            *(x.data_ptr() for x in plan_tables(n // N2, device)),
            tb.twr.data_ptr(), tb.twi.data_ptr())


def plan_ints(n: int) -> tuple[int, int]:
    """(number of in-place passes, generic radix) of the plan for n."""
    p = fft_plan(n // N2)
    return len(p.radices), p.rg


def power_scale(n: int) -> float:
    """The PSD correction (2/n)^2 as the float32 the kernels use."""
    return float(np.float32((2.0 / n) ** 2))


def wf_group_for(n: int, max_width: int = 2048) -> int:
    """Smallest divisor q of n1 = n//128 with (n1//q)*128 <= max_width
    (the in-kernel waterfall decimation group; 96 k -> q=5 / width 1920,
    192 k -> q=10 / width 1920)."""
    n1 = n // N2
    for q in range(1, n1 + 1):
        if n1 % q == 0 and (n1 // q) * N2 <= max_width:
            return q
    return n1


def check_geometry(fn: str, t_len: int, n: int, q: int) -> None:
    """Raise unless n-sample blocks tile T and the kernels take n and q."""
    n1 = n // N2
    if n % N2 or not 1 <= n1 <= MAX_N1:
        raise ValueError(f"{fn}: n = {n} must be a multiple of 128 with "
                         f"n // 128 <= {MAX_N1}")
    if t_len % n:
        raise ValueError(f"{fn}: T = {t_len} is not a multiple of n = {n}")
    if n1 % q:
        raise ValueError(f"{fn}: the group q = {q} must divide n1 = {n1}")


def _windowed(iq: CF, n: int, tb: SpecTables):
    """The windowed blocks as [S, T//n, n1, 128] planes."""
    s, t_len = iq.shape
    shape = (s, t_len // n, n // N2, N2)
    win = tb.win.view(n // N2, N2)
    return iq.re.reshape(shape) * win, iq.im.reshape(shape) * win


def _lines(dr, di, n: int, q: int):
    """(wf, peak dB, idx) from D [S, T//n, n1, 128] (natural k1, k2)."""
    s, nblk, n1 = dr.shape[:3]
    power = (dr * dr + di * di) * power_scale(n)
    db = 10.0 * torch.log10(torch.clamp_min(power, _EPS))
    wf = db.reshape(s, nblk, n1 // q, q, N2).amax(dim=3)
    flat = power.reshape(s, nblk, n1 * N2)
    idx = torch.argmax(flat, dim=-1)                 # the first maximum
    mx = 10.0 * torch.log10(torch.clamp_min(flat.amax(dim=-1), _EPS))
    return (wf.permute(1, 0, 2, 3).contiguous(), mx.T.contiguous(),
            idx.T.to(torch.int32).contiguous())


def spectrum_wf_ref(iq: CF, n: int, window: bool = True, q: int = 1):
    """Plain PyTorch version: the two-stage DFT as ``torch.matmul`` on the
    float32 DFT tables (in true fp32 on a card: ``require_device`` turns
    TF32 off), then power, dB, the max over q consecutive k1 and the first
    maximum of the power in permuted flat order. Returns (wf
    [T//n, S, n1//q, 128], peak dB [T//n, S], idx [T//n, S] int32)."""
    tb = spec_tables(n, window, iq.re.device)
    ar, ai = _windowed(iq, n, tb)
    br = tb.w1r @ ar - tb.w1i @ ai
    bi = tb.w1r @ ai + tb.w1i @ ar
    cr = br * tb.twr - bi * tb.twi
    ci = br * tb.twi + bi * tb.twr
    dr = cr @ tb.w2r.T - ci @ tb.w2i.T
    di = cr @ tb.w2i.T + ci @ tb.w2r.T
    return _lines(dr, di, n, q)


def spectrum_fft_ref(iq: CF, n: int, window: bool = True, q: int = 1,
                     ranks: int = 1):
    """Plain mirror of the kernels' factored FFT: the same window and
    outputs as :func:`spectrum_wf_ref`, with the transform taken pass by
    pass on the plan's float32 tables (:func:`.fft_plan.fft_block`), the
    block held as one CTA holds it (``ranks=1``) or as a cluster of
    ``ranks`` CTAs does (``CLUSTER``: stage 1 on each rank's 32 columns,
    stage 2's rows gathered across the ranks). Only the tests call it: it
    is the CPU witness that the tables the kernels read compute the DFT,
    and that both layouts give the same bits."""
    ar, ai = _windowed(iq, n, spec_tables(n, window, iq.re.device))
    return _lines(*fft_block(fft_plan(n // N2), ar, ai, ranks=ranks), n, q)


def _spectrum_wf(iq: CF, n: int, window: bool, q: int, cluster: bool):
    """Kernel 4 for CUDA tensors, its plain version for CPU tensors."""
    s, t_len = iq.shape
    dev = iq.re.device
    check_geometry("spectrum_fused", t_len, n, q)
    for name, x in (("iq.re", iq.re), ("iq.im", iq.im)):
        _build.check_tensor("spectrum_fused", name, x, (s, t_len),
                            torch.float32, dev)
    if dev.type == "cpu":
        return spectrum_wf_ref(iq, n, window, q)
    if dev.type != "cuda":
        raise ValueError(f"spectrum_fused: unsupported device {dev}")

    n1, nblk = n // N2, t_len // n
    wf = torch.empty((nblk, s, n1 // q, N2), dtype=torch.float32, device=dev)
    mx = torch.empty((nblk, s), dtype=torch.float32, device=dev)
    idx = torch.empty((nblk, s), dtype=torch.int32, device=dev)
    if wf.numel() == 0:
        return wf, mx, idx
    lib = _build.kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.jsdr_spectrum_wf(
            iq.re.data_ptr(), iq.im.data_ptr(), *kernel_tables(n, window, dev),
            wf.data_ptr(), mx.data_ptr(), idx.data_ptr(), s, t_len, n1, q,
            *plan_ints(n), power_scale(n), cuda_ranks(n, cluster), stream)
    _build.check(code, "spectrum_fused")
    spectrum_fused.launches += 1
    return wf, mx, idx


def spectrum_fused(iq: CF, n: int, window: bool = True,
                   with_peaks: bool = False, cluster: bool = False):
    """Fused window + FFT + PSD (+ peak search) over contiguous time rows.

    iq: CF of float32 [S, T] with T % n == 0, n % 128 == 0 and
    n // 128 <= 512 (on a card one CTA a block up to 225, a 4-CTA cluster
    above; ``cluster`` as in :func:`cuda_ranks`). Returns the dB PSD as
    [T//n, S, n1, 128] in PERMUTED frequency order (element [..., k1, k2]
    is natural bin n1*k2 + k1; :func:`spectrum_natural_order` flattens
    it). ``with_peaks=True`` also returns (peak_db [T//n, S], flat
    permuted argmax [T//n, S] int32), computed in the kernel."""
    psd, mx, idx = _spectrum_wf(iq, n, window, 1, cluster)
    return (psd, mx, idx) if with_peaks else psd


spectrum_fused.launches = 0


def spectrum_waterfall(iq: CF, n: int, window: bool = True,
                       max_width: int = 2048, cluster: bool = False):
    """Fused window + FFT + PSD -> DISPLAY-decimated dB lines + peaks,
    never materialising the full PSD: the max over q =
    ``wf_group_for(n, max_width)`` consecutive k1 at fixed k2, which is a
    natural-order decimation (natural bin n1*k2 + k1).

    Returns (wf [T//n, S, n1//q, 128] dB, peak_db [T//n, S], flat permuted
    argmax [T//n, S]). Display pixel p = (n1//q)*k2 + g; use
    :func:`waterfall_natural_order` to flatten. The same kernel as
    :func:`spectrum_fused`, counted in ``spectrum_fused.launches``."""
    return _spectrum_wf(iq, n, window, wf_group_for(n, max_width), cluster)


def spectrum_natural_order(psd_perm: torch.Tensor) -> torch.Tensor:
    """[nblk, S, n1, n2] permuted PSD -> [S, nblk, n] natural order."""
    nblk, s, n1, n2 = psd_perm.shape
    return psd_perm.permute(1, 0, 3, 2).reshape(s, nblk, n1 * n2)


def waterfall_natural_order(wf: torch.Tensor) -> torch.Tensor:
    """[nblk, S, G, n2] decimated lines -> [S, nblk, G*n2] natural pixel
    order (pixel p = G*k2 + g)."""
    nblk, s, g, n2 = wf.shape
    return wf.permute(1, 0, 3, 2).reshape(s, nblk, g * n2)
