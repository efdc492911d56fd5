"""The plan of the spectrum kernels' factored FFT, and a plain mirror of it.

The spectrum kernels (``csrc/spectrum_body.cuh``) compute each block's
two-stage transform (n = n1 * 128; A[j, c] = a[128*j + c]; stage 1 an
n1-point DFT down each column, the twiddle ``TW[k1, c]``, stage 2 a
128-point DFT along each row) as a factored FFT. Everything the kernel
indexes by is built here on the host, in numpy, once per n1:

* stage 1, in place over the [n1, 128] block in shared memory: n1 is
  factored into radices 4 and 2 first, then 3 and 5; each is one
  decimation-in-frequency pass (``passes``: radix r, sub-transform length
  L, stride s = L/r, offset of its twiddles). Butterfly (blk, j), j < s,
  reads rows blk*L + j + m*s (m < r), takes their r-point DFT and
  multiplies output k by W_L^(j*k) (``ptw`` at offset + j*(r-1) + k-1).
  The prime factors above 5 are left as one generic radix ``rg`` (their
  product), a direct rg-point DFT over aligned groups of rg rows
  (``gw[t]`` = W_rg^t) that the kernel computes as it reads a row in
  stage 2. The output stays in digit-reversed rows: frequency k1 is in
  storage row ``perm[k1]``;
* stage 2, a warp per row: lane l holds c = l + 32*i (i < 4); a 4-point
  DFT over its registers, the twiddle W_128^(l*u) (``s2tw[l, u-1]``), then
  a 32-point radix-2 FFT across lanes (span h = 16, 8, 4, 2, 1; on the
  upper lane of a pair the difference is multiplied by W_2h^(l mod h),
  ``s2tw[l, 3 + stage]``, and by 1 on the lower lane). Lane l, register
  u then holds k2 = ``k2map[l, u]`` = u + 4*bitrev5(l): four consecutive
  bins from ``k2map[l, 0]``, a multiple of 4.

Every table is kept in complex128 (angles in float64 with the index
product reduced mod its length, as ``mxu_fft`` builds its tables); the
kernel reads them rounded to float32 (:func:`plan_tables`).

:func:`stage1` and :func:`fft_block` mirror the kernel's pass order on
tensors, in float64 with the exact tables or in float32 with the rounded
ones; they are the CPU witness that the tables compute a DFT
(``spectrum_fused.spectrum_fft_ref`` builds the spectrum on them). No
main path calls them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

N2 = 128
LANES = 32
REGS = N2 // LANES               # stage 2: values per lane
PASS_RADICES = (4, 2, 3, 5)      # in this order; the kernel's butterflies
SPANS = (16, 8, 4, 2, 1)         # stage 2: the lane spans of its FFT


def unit(num, den: int) -> np.ndarray:
    """W_den^num = exp(-2*pi*i*num/den), complex128, num reduced mod den."""
    ang = -2.0 * np.pi * (np.asarray(num, np.int64) % den) / den
    return np.cos(ang) + 1j * np.sin(ang)


def factor(n1: int) -> tuple[tuple[int, ...], int]:
    """(the in-place radices in pass order, the generic radix rg: the
    product of n1's prime factors above 5, 1 when there are none)."""
    radices, rest = [], n1
    for r in PASS_RADICES:
        while rest % r == 0:
            radices.append(r)
            rest //= r
    return tuple(radices), rest


class FftPlan(NamedTuple):
    n1: int
    radices: tuple      # in-place passes, in order
    rg: int             # the generic radix (1: none)
    passes: np.ndarray  # int32 [P, 4]: radix, L, stride, twiddle offset
    ptw: np.ndarray     # complex128: every pass's W_L^(j*k), k = 1..r-1
    perm: np.ndarray    # int32 [n1]: storage row of frequency k1
    gw: np.ndarray      # complex128 [rg]: W_rg^t
    s2tw: np.ndarray    # complex128 [32, 7]: stage 2's lane twiddles
    k2map: np.ndarray   # int32 [32, 4]: k2 of lane l, register u


def _bitrev5(v: np.ndarray) -> np.ndarray:
    return sum(((v >> b) & 1) << (4 - b) for b in range(5))


@functools.lru_cache(maxsize=64)
def fft_plan(n1: int) -> FftPlan:
    """The plan for n1 (built once)."""
    if n1 < 1:
        raise ValueError(f"fft_plan: n1 = {n1} must be >= 1")
    radices, rg = factor(n1)
    passes, ptw, length, off = [], [], n1, 0
    for r in radices:
        s = length // r
        j, k = np.meshgrid(np.arange(s), np.arange(1, r), indexing="ij")
        ptw.append(unit(j * k, length).reshape(-1))
        passes.append((r, length, s, off))
        off += s * (r - 1)
        length = s
    k1 = np.arange(n1)
    perm, rest, length = np.zeros(n1, np.int64), k1.copy(), n1
    for r in radices + ((rg,) if rg > 1 else ()):
        length //= r
        perm += (rest % r) * length
        rest //= r
    lane = np.arange(LANES)
    s2tw = np.ones((LANES, 7), np.complex128)
    for u in range(1, REGS):
        s2tw[:, u - 1] = unit(lane * u, N2)
    for st, h in enumerate(SPANS[:-1]):
        upper = (lane & h) != 0
        s2tw[upper, 3 + st] = unit(lane[upper] & (h - 1), 2 * h)
    k2map = np.arange(REGS)[None, :] + REGS * _bitrev5(lane)[:, None]
    return FftPlan(
        n1, radices, rg,
        np.asarray(passes, np.int32).reshape(-1, 4),
        np.concatenate(ptw) if ptw else np.zeros(0, np.complex128),
        perm.astype(np.int32), unit(np.arange(rg), rg), s2tw,
        k2map.astype(np.int32))


def twiddle(n1: int) -> np.ndarray:
    """TW[k1, c] = W_n^(k1*c), complex128 [n1, 128] (its float32 rounding
    is ``mxu_fft._twiddles(n1, 128, -1)``)."""
    return unit(np.arange(n1)[:, None] * np.arange(N2)[None, :], n1 * N2)


def _f32(z: np.ndarray):
    return (np.ascontiguousarray(z.real, np.float32),
            np.ascontiguousarray(z.imag, np.float32))


class PlanTables(NamedTuple):
    """The plan as the kernels read it, in the order of their C
    arguments (before TW): float32 planes, int32 indices."""
    passes: torch.Tensor
    ptw_r: torch.Tensor
    ptw_i: torch.Tensor
    perm: torch.Tensor
    gw_r: torch.Tensor
    gw_i: torch.Tensor
    s2_r: torch.Tensor
    s2_i: torch.Tensor
    k2map: torch.Tensor


@functools.lru_cache(maxsize=16)
def _plan_on(n1: int, device: str) -> PlanTables:
    p = fft_plan(n1)
    host = (p.passes, *_f32(p.ptw), p.perm, *_f32(p.gw), *_f32(p.s2tw),
            p.k2map)
    return PlanTables(*(torch.as_tensor(np.ascontiguousarray(a),
                                        device=device) for a in host))


def plan_tables(n1: int, device) -> PlanTables:
    """The plan's device tables for n1 on ``device`` (built once)."""
    return _plan_on(n1, str(torch.device(device)))


# ---- the plain mirror of the kernel's pass order ---------------------------

def _cplx(z: np.ndarray, like: torch.Tensor, exact: bool):
    """(re, im) of a complex128 table as tensors like ``like``: exact, or
    rounded to float32 as the kernel reads it."""
    re, im = (z.real, z.imag) if exact else _f32(z)
    return (torch.as_tensor(np.asarray(re), dtype=like.dtype,
                            device=like.device),
            torch.as_tensor(np.asarray(im), dtype=like.dtype,
                            device=like.device))


def _dft(wr, wi, xr, xi, eq):
    """The complex product einsum(eq, w, x) on planes."""
    return (torch.einsum(eq, wr, xr) - torch.einsum(eq, wi, xi),
            torch.einsum(eq, wr, xi) + torch.einsum(eq, wi, xr))


def stage1(plan: FftPlan, re: torch.Tensor, im: torch.Tensor,
           exact: bool = False):
    """Stage 1 over the rows of [..., n1, C] planes, pass by pass as the
    kernel runs it (the generic radix last): returns the columns' n1-point
    DFTs in storage rows (frequency k1 in row ``plan.perm[k1]``)."""
    lead, n1, cols = re.shape[:-2], plan.n1, re.shape[-1]
    for r, length, s, off in plan.passes.tolist():
        shape = (*lead, n1 // length, r, s, cols)
        m = np.arange(r)
        wr, wi = _cplx(unit(m[:, None] * m[None, :], r), re, exact)
        yr, yi = _dft(wr, wi, re.reshape(shape), im.reshape(shape),
                      "km,...bmjc->...bkjc")
        tw = np.ones((r, s), np.complex128)
        tw[1:] = plan.ptw[off:off + s * (r - 1)].reshape(s, r - 1).T
        tr, ti = _cplx(tw, re, exact)
        tr, ti = tr[:, :, None], ti[:, :, None]
        re = (yr * tr - yi * ti).reshape(*lead, n1, cols)
        im = (yr * ti + yi * tr).reshape(*lead, n1, cols)
    if plan.rg > 1:
        rg = plan.rg
        m = np.arange(rg)
        wr, wi = _cplx(plan.gw[(m[:, None] * m[None, :]) % rg], re, exact)
        shape = (*lead, n1 // rg, rg, cols)
        yr, yi = _dft(wr, wi, re.reshape(shape), im.reshape(shape),
                      "km,...bmc->...bkc")
        re, im = yr.reshape(*lead, n1, cols), yi.reshape(*lead, n1, cols)
    return re, im


def stage2(plan: FftPlan, re: torch.Tensor, im: torch.Tensor,
           exact: bool = False):
    """Stage 2 over the rows of [..., 128] planes as a warp computes it:
    the 4-point DFT over registers, the W_128^(l*u) twiddle, the 32-point
    FFT across lanes, then each (lane, register) value put at its k2."""
    lead = re.shape[:-1]
    i = np.arange(REGS)
    wr, wi = _cplx(unit(i[:, None] * i[None, :], REGS), re, exact)
    xr, xi = _dft(wr, wi, re.reshape(*lead, REGS, LANES),
                  im.reshape(*lead, REGS, LANES), "ui,...il->...ul")
    tw = np.ones((REGS, LANES), np.complex128)
    tw[1:] = plan.s2tw[:, :REGS - 1].T
    tr, ti = _cplx(tw, re, exact)
    xr, xi = xr * tr - xi * ti, xr * ti + xi * tr
    for st, h in enumerate(SPANS):
        shape = (*lead, REGS, LANES // (2 * h), 2, h)
        xr, xi = xr.reshape(shape), xi.reshape(shape)
        lo_r, hi_r = xr[..., 0, :], xr[..., 1, :]
        lo_i, hi_i = xi[..., 0, :], xi[..., 1, :]
        dr, di = lo_r - hi_r, lo_i - hi_i
        if h > 1:
            tr, ti = _cplx(plan.s2tw[:, 3 + st].reshape(-1, 2, h)[:, 1],
                           re, exact)
            dr, di = dr * tr - di * ti, dr * ti + di * tr
        xr = torch.stack([lo_r + hi_r, dr], dim=-2).reshape(*lead, REGS,
                                                            LANES)
        xi = torch.stack([lo_i + hi_i, di], dim=-2).reshape(*lead, REGS,
                                                            LANES)
    k2 = torch.as_tensor(plan.k2map.T.reshape(-1), device=re.device,
                         dtype=torch.long)
    out_r, out_i = torch.empty_like(re), torch.empty_like(im)
    out_r[..., k2] = xr.reshape(*lead, N2)
    out_i[..., k2] = xi.reshape(*lead, N2)
    return out_r, out_i


def fft_block(plan: FftPlan, re: torch.Tensor, im: torch.Tensor,
              exact: bool = False, ranks: int = 1):
    """The whole transform of [..., n1, 128] blocks A by the kernel's pass
    order: stage 1, the rows gathered by ``perm``, the twiddle TW, stage
    2. Returns D[..., k1, k2] = X[n1*k2 + k1] in natural k1 and k2.

    ``ranks`` is the number of CTAs that hold a block
    (``csrc/spectrum_body.cuh``): rank r runs stage 1 on columns
    [r*C, (r+1)*C) (C = 128 / ranks) as flat [n1][C] planes, and stage 2
    reads column c of storage row p from rank c // C at word
    p*C + c % C (with 4 ranks, lane l's register i from rank i at word
    p*32 + l). Stage 1 acts on each column alone, so every rank count
    gives the same bits."""
    cols = N2 // ranks
    planes = [stage1(plan, re[..., r * cols:(r + 1) * cols],
                     im[..., r * cols:(r + 1) * cols], exact)
              for r in range(ranks)]
    dev = re.device
    perm = torch.as_tensor(plan.perm, dtype=torch.long, device=dev)
    c = torch.arange(N2, device=dev)
    word = perm[:, None] * cols + (c % cols)[None, :]        # [n1, 128]
    rank = (c // cols)[None, :].expand_as(word)
    br, bi = (torch.stack([p[k].flatten(-2) for p in planes],
                          dim=-2)[..., rank, word] for k in (0, 1))
    tr, ti = _cplx(twiddle(plan.n1), re, exact)
    return stage2(plan, br * tr - bi * ti, br * ti + bi * tr, exact)
