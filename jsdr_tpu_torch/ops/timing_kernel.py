"""Batched bit-timing recovery — the port of
``jsdr_tpu/ops/timing_kernel.py::_timing_kernel`` (wrapper
``timing_recover_batch``).

Counterpart of ``jsdr_tpu.demod.bpsk._timing_parallel`` over [S, T_ds]
matched-filter rows (FUNcubeBPSKDemod.java:505-595): 8 energy EMAs per
stream, a first-maximum argmax per 8-sample bit group, the delayed
peak/new_peak hand-off, two emission slots per group (slot 0 at peak0 if
peak0 <= (peak0+4)%8, slot 1 at new_peak if new_peak > (peak0+4)%8), the
differential decision against the previous emission with the energy gate,
and the e_out EMA. :func:`timing_recover_batch` launches the CUDA kernel
(``csrc/timing.cu``) for CUDA tensors and runs :func:`timing_recover_ref`
for CPU tensors. :func:`_timing_chunked_ref` mirrors the kernel's walk
over chunks of :data:`CHUNK_GROUPS` groups, for the CPU tests only.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

P_PHASES = 8
# bit groups per chunk that one CTA stages into shared memory; also its
# worker threads (one a group), so a multiple of 32 up to the kernel's 256
CHUNK_GROUPS = 128


def _coeffs(smooth1: float, smooth2: float):
    """(s1, 1-s1, s2, 1-s2) as float32 values, so that every evaluation of
    the recurrences multiplies by the same numbers."""
    return tuple(float(np.float32(v)) for v in
                 (smooth1, 1.0 - smooth1, smooth2, 1.0 - smooth2))


def timing_recover_ref(mf_re, mf_im, e_ema, peak, new_peak, e_out, last_iq,
                       *, smooth1: float, smooth2: float, gate: float):
    """Plain PyTorch version. The EMA and e_out recurrences run as loops
    over bit groups (vectorised over streams) in the kernel's evaluation
    order; the peak schedule, slot extraction and previous-emission fill
    are vectorised over groups. Returns the same 7-tuple as
    :func:`timing_recover_batch`."""
    s, t_ds = mf_re.shape
    g = t_ds // P_PHASES
    s1, a1, s2, a2 = _coeffs(smooth1, smooth2)
    fi = mf_re.reshape(s, g, P_PHASES)
    fq = mf_im.reshape(s, g, P_PHASES)
    e1 = fi * fi + fq * fq
    b = e1 * s1

    traj = torch.empty_like(e1)                 # EMAs after each group
    ema = e_ema
    for k in range(g):
        ema = ema * a1 + b[:, k]
        traj[:, k] = ema
    am = torch.argmax(traj, dim=2)              # first maximum
    np0 = torch.cat([new_peak.long()[:, None], am[:, :-1]], dim=1)
    pk0 = torch.cat([peak.long()[:, None], np0[:, :-1]], dim=1)
    h = (pk0 + 4) % P_PHASES
    slot_p = torch.stack([pk0, np0], dim=-1)               # [S, G, 2]
    on = torch.stack([pk0 <= h, np0 > h], dim=-1).reshape(s, 2 * g)
    vi = fi.gather(2, slot_p).reshape(s, 2 * g)
    vq = fq.gather(2, slot_p).reshape(s, 2 * g)
    e1s = e1.gather(2, slot_p).reshape(s, 2 * g)

    # previous emission (exclusive), seeded by the carried last_iq
    pos = torch.arange(2 * g, device=mf_re.device).expand(s, -1)
    last_on = torch.where(on, pos, -1).cummax(dim=1).values  # inclusive
    prev = torch.cat([last_on.new_full((s, 1), -1), last_on[:, :-1]], dim=1)
    have = prev >= 0
    at = prev.clamp(min=0)
    prev_i = torch.where(have, vi.gather(1, at), last_iq[:, :1])
    prev_q = torch.where(have, vq.gather(1, at), last_iq[:, 1:])

    di = -(prev_i * vi + prev_q * vq)
    dq = prev_i * vq - prev_q * vi
    e2 = torch.sqrt(di * di + dq * dq)
    valid = on & (e2 > gate)
    bit = di < 0.0

    eo = e_out
    contrib = e1s * s2
    for k in range(2 * g):
        eo = torch.where(on[:, k], eo * a2 + contrib[:, k], eo)

    fin = last_on[:, -1:]
    fired = fin >= 0
    fin = fin.clamp(min=0)
    last_iq_f = torch.where(fired, torch.cat([vi.gather(1, fin),
                                              vq.gather(1, fin)], dim=1),
                            last_iq)
    return (valid, bit, ema, np0[:, -1].to(torch.int32),
            am[:, -1].to(torch.int32), eo, last_iq_f)


def _timing_chunked_ref(mf_re, mf_im, e_ema, peak, new_peak, e_out, last_iq,
                        *, smooth1: float, smooth2: float, gate: float,
                        chunk: int = CHUNK_GROUPS):
    """The kernel's decomposition in plain PyTorch: each stream walked in
    chunks of ``chunk`` groups with the kernel's carries, and every value
    computed in :func:`timing_recover_ref`'s order, so the two agree bit
    for bit. Per chunk: the 8 per-phase EMA chains (the only serial loop
    over groups); per group, the first-maximum argmax, pk0/np0 from the
    argmaxes one and two groups back (carried across chunks as peak and
    new_peak), the fire flags and slot values; each fired slot's rank (the
    fired slots before it in the chunk) places it in the chunk's list of
    fired slots, and a slot decides against the entry one rank below its
    own, or the carried last_iq at rank 0; e_out runs over the list; the
    last entry becomes the carried last_iq. Returns the 7-tuple of
    :func:`timing_recover_batch`. Nothing on the main path calls it."""
    s, t_ds = mf_re.shape
    g = t_ds // P_PHASES
    s1, a1, s2, a2 = _coeffs(smooth1, smooth2)
    fi = mf_re.reshape(s, g, P_PHASES)
    fq = mf_im.reshape(s, g, P_PHASES)
    ema, eo = e_ema, e_out
    pk_c, np_c = peak.long(), new_peak.long()
    li, lq = last_iq[:, 0], last_iq[:, 1]
    valid = torch.empty((s, g, 2), dtype=torch.bool, device=mf_re.device)
    bit = torch.empty_like(valid)
    for g0 in range(0, g, chunk):
        xr, xq = fi[:, g0:g0 + chunk], fq[:, g0:g0 + chunk]
        cv = xr.shape[1]
        traj = torch.empty_like(xr)                 # the chain lanes
        for k in range(cv):
            e1 = xr[:, k] * xr[:, k] + xq[:, k] * xq[:, k]
            ema = ema * a1 + e1 * s1
            traj[:, k] = ema
        am = torch.argmax(traj, dim=2)              # the workers
        np0 = torch.cat([np_c[:, None], am[:, :-1]], dim=1)
        pk0 = torch.cat([pk_c[:, None], np0[:, :-1]], dim=1)
        h = (pk0 + 4) % P_PHASES
        on = torch.stack([pk0 <= h, np0 > h], dim=-1).reshape(s, 2 * cv)
        slot_p = torch.stack([pk0, np0], dim=-1)
        vi = xr.gather(2, slot_p).reshape(s, 2 * cv)
        vq = xq.gather(2, slot_p).reshape(s, 2 * cv)
        rank = on.long().cumsum(dim=1) - on.long()  # fired slots before
        total = on.sum(dim=1)
        # the list of fired slots; unfired slots write a spare last column
        at = torch.where(on, rank, 2 * cv)
        lst = [torch.zeros((s, 2 * cv + 1), dtype=v.dtype,
                           device=v.device).scatter_(1, at, v)[:, :2 * cv]
               for v in (vi, vq, (vi * vi + vq * vq) * s2)]
        below = (rank - 1).clamp(min=0)
        have = rank > 0
        prev_i = torch.where(have, lst[0].gather(1, below), li[:, None])
        prev_q = torch.where(have, lst[1].gather(1, below), lq[:, None])
        di = -(prev_i * vi + prev_q * vq)
        dq = prev_i * vq - prev_q * vi
        e2 = torch.sqrt(di * di + dq * dq)
        valid[:, g0:g0 + cv] = (on & (e2 > gate)).reshape(s, cv, 2)
        bit[:, g0:g0 + cv] = (di < 0.0).reshape(s, cv, 2)
        for k in range(2 * cv):                     # the e_out lane
            eo = torch.where(k < total, eo * a2 + lst[2][:, k], eo)
        last = (total - 1).clamp(min=0)[:, None]
        li = torch.where(total > 0, lst[0].gather(1, last)[:, 0], li)
        lq = torch.where(total > 0, lst[1].gather(1, last)[:, 0], lq)
        pk_c, np_c = np0[:, -1], am[:, -1]
    return (valid.reshape(s, 2 * g), bit.reshape(s, 2 * g), ema,
            pk_c.to(torch.int32), np_c.to(torch.int32), eo,
            torch.stack([li, lq], dim=1))


@_build.counts_launches
def timing_recover_batch(mf_re, mf_im, e_ema, peak, new_peak, e_out,
                         last_iq, *, smooth1: float, smooth2: float,
                         gate: float):
    """Batched bit-timing recovery over [S, T_ds] matched-filter rows,
    T_ds a positive multiple of 8.

    State: e_ema [S, 8] f32, peak/new_peak [S] i32, e_out [S] f32,
    last_iq [S, 2] f32. Returns (valid [S, 2G] bool, bit [S, 2G] bool,
    e_ema', peak', new_peak', e_out', last_iq') with slots (g, 0) and
    (g, 1) interleaved, as ``jsdr_tpu.ops.timing_kernel.
    timing_recover_batch`` returns them. ``bit`` is meaningful only
    where ``valid``.

    CPU tensors run :func:`timing_recover_ref`; CUDA tensors launch the
    kernel (and count the launch in ``timing_recover_batch.launches``)."""
    s, t_ds = mf_re.shape
    dev = mf_re.device
    if t_ds == 0 or t_ds % P_PHASES:
        raise ValueError(f"matched-filter length {t_ds} must be a positive "
                         f"multiple of {P_PHASES}")
    f32, i32 = torch.float32, torch.int32
    for name, x, shape, dt in (("mf_re", mf_re, (s, t_ds), f32),
                               ("mf_im", mf_im, (s, t_ds), f32),
                               ("e_ema", e_ema, (s, P_PHASES), f32),
                               ("peak", peak, (s,), i32),
                               ("new_peak", new_peak, (s,), i32),
                               ("e_out", e_out, (s,), f32),
                               ("last_iq", last_iq, (s, 2), f32)):
        _build.check_tensor("timing_recover_batch", name, x, shape, dt, dev)
    kw = dict(smooth1=smooth1, smooth2=smooth2, gate=gate)
    if dev.type == "cpu":
        return timing_recover_ref(mf_re, mf_im, e_ema, peak, new_peak,
                                  e_out, last_iq, **kw)
    if dev.type != "cuda":
        raise ValueError(f"timing_recover_batch: unsupported device {dev}")
    if mf_re.data_ptr() % 16 or mf_im.data_ptr() % 16:
        raise ValueError("timing_recover_batch: mf planes must be 16-byte "
                         "aligned (the kernel copies 16-byte vectors)")

    g = t_ds // P_PHASES
    valid = torch.empty((s, 2 * g), dtype=torch.bool, device=dev)
    bit = torch.empty_like(valid)
    ema_f = torch.empty_like(e_ema)
    peak_f = torch.empty_like(peak)
    new_peak_f = torch.empty_like(new_peak)
    e_out_f = torch.empty_like(e_out)
    last_f = torch.empty_like(last_iq)
    s1, a1, s2, a2 = _coeffs(smooth1, smooth2)
    lib = _build.kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.jsdr_timing_recover(
            mf_re.data_ptr(), mf_im.data_ptr(), e_ema.data_ptr(),
            peak.data_ptr(), new_peak.data_ptr(), e_out.data_ptr(),
            last_iq.data_ptr(), valid.data_ptr(), bit.data_ptr(),
            ema_f.data_ptr(), peak_f.data_ptr(), new_peak_f.data_ptr(),
            e_out_f.data_ptr(), last_f.data_ptr(), s, g, CHUNK_GROUPS, s1,
            a1, s2, a2, float(gate), stream)
    _build.check(code, "timing_recover_batch")
    timing_recover_batch.launches += 1
    return valid, bit, ema_f, peak_f, new_peak_f, e_out_f, last_f
