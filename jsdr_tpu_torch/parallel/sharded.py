"""Sharded telemetry step — the port of :mod:`jsdr_tpu.parallel.sharded`.

Layout over a ("dp", "sp") :class:`~jsdr_tpu_torch.parallel.mesh.Mesh`:
streams (the N independent demod instances, each with its own tuning and
dofft/track_high flags, jsdr.java:479-484) are partitioned over dp, each
stream's time axis over sp. The shards a process owns sit stacked on its
device: every tensor of the step below leads with K, the process's sp
shards, and holds all of the process's streams (dp needs no
communication in this step).

**Front end** (full rate): manual streams mix with the exact
integer-numerator NCO at their global sample offsets; auto-tuned (dofft)
streams run the FFT tuner's per-0.1 s analysis on each shard, and only
its 3-scalar EMA state relays across shards (n_sp-1 rounds). The
decimating FIR's 26-sample halo travels the ring as mixed-domain
samples, and shard 0's halo is the carried tail, so consecutive steps
chain bit-exactly with :func:`~jsdr_tpu_torch.demod.bpsk.
bpsk_block_batch`. Like the reference, the front end is the general mix
and ``polyphase_decimate`` (no kernel).

**Decode tail** (9600 Hz), sharded over sp as well; every cross-shard
dependence is a small carried state:

- VCO mix: the phase is exactly (pi/4)*(global index), so no exchange;
- 65-tap matched filter: a 64-sample ring halo;
- bit-timing EMA: the constant-decay recurrence is affine, so each shard
  computes its zero-init trajectory and the boundary values resolve in
  closed form from one all_gather of [8]-vectors;
- peak schedule: np0/peak0 of a shard's first groups are the argmaxes of
  the left neighbour's last two groups (a 2-scalar hop);
- the differential decoder's last-valid chain: a local log-shift fill,
  then the boundary emission resolves from one all_gather of 3 scalars;
- e_out: an emission-count-weighted suffix sum composes from per-shard
  (count, contribution) pairs;
- bits: each shard compacts its own slots, the compacted segments are
  gathered and placed at their global offsets; the stride-80 sync
  correlation and window extraction are sharded by candidate position,
  and the per-shard hits merge in position order (first max_hits win).

Everything carried lands in the same ``BpskState``, so the step chains
with ``bpsk_block_batch`` and with itself. Two float orders differ from
the single-device chain: the EMA (triangular products and the affine
composition, against the timing kernel's serial sum) and e_out. So the
carried float state agrees within rtol 2e-4, and a noise-only stream's
bit decisions may differ on a near-tie; streams that carry a signal
decode bit-exactly (tests/test_torch_parallel.py).

``compat_scan=True`` (the per-sample fp-order mode) gathers the decimated
stream and runs the single-device tail (``_post_batch`` with the scan):
the sequential scan cannot shard over time.

The reference's multi-host layout maps onto processes: each process
passes its own part of the inputs (its dp rows' streams and its sp
columns' samples) and gets its streams' outputs and state, replicated
over its sp shards.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..demod import bpsk as B
from ..demod.fft_tuner import (FftTunerState, tuner_emit, tuner_precompute,
                               tuner_recurrence)
from ..ops.cplx import CF, from_complex
from ..ops.fir import fir_apply_streaming, polyphase_decimate
from ..ops.spectrum import spectrum_block
from ..runtime.state import tree_map
from .mesh import Mesh


def _front_manual_local(iq: CF, nu0: torch.Tensor, tu: torch.Tensor,
                        sp: torch.Tensor, *, rate: int) -> CF:
    """Exact-numerator NCO mix of each shard's samples at their global
    offsets (RxMixTuner at scale, FUNcubeBPSKDemod.java:382-397).
    iq: [K, S, t_loc]; nu0, tu: [S]; sp: [K] global sp positions."""
    t_loc = iq.shape[-1]
    den = B.NU_SCALE * rate
    g0 = (sp * (t_loc % den)) % den                          # [K]
    nu_shard = (nu0.long()[None] + B._modmul_traced(tu[None], g0[:, None],
                                                    den)) % den
    nums = B.nco_numerators(nu_shard, tu[None].expand_as(nu_shard), t_loc,
                            den, start=1)
    c, s = B._num_to_cossin(nums, den)
    on = (tu > 0)[None, :, None]
    return CF(iq.re * torch.where(on, c, 1.0),
              iq.im * torch.where(on, s, 1.0))


def _front_dofft_local(iq: CF, ft0: FftTunerState, track_high: torch.Tensor,
                       mesh: Mesh, *, rate: int):
    """doBufferFFT front end per time shard: the per-block FFT/peak
    analysis runs on every shard at once; the 3-scalar tuner recurrence
    relays along sp (n_sp-1 rounds), then each shard emits its slices.
    Returns (feed CF [K, S, t_loc], each shard's final tuner state
    [K, S] leaves: the last shard's is the carried one)."""
    k_loc, s, t_loc = iq.shape
    samples = rate // 10
    if t_loc % samples:
        raise ValueError("dofft sharding needs whole 0.1 s blocks per shard")
    nb = t_loc // samples
    blocks = CF(iq.re.reshape(k_loc * s, nb, samples),
                iq.im.reshape(k_loc * s, nb, samples))
    spec, ave, bin_pos, max_bin, end = tuner_precompute(
        blocks, track_high.repeat(k_loc))
    sp = mesh.axis_index("sp")[:, None]
    n_sp = mesh.shape["sp"]

    def rec(st: FftTunerState):
        flat = tree_map(lambda x: x.reshape(k_loc * s), st)
        out, centres = tuner_recurrence(flat, ave, bin_pos, max_bin, end)
        return tree_map(lambda x: x.reshape(k_loc, s), out), centres

    st_in = tree_map(lambda x: x[None].expand(k_loc, s), ft0)  # rank 0's
    for r in range(n_sp - 1):
        st_out, _ = rec(st_in)
        st_in = tree_map(
            lambda cur, new: torch.where(sp == r + 1, new, cur), st_in,
            tree_map(lambda x: mesh.ring(x, "sp", wrap=False), st_out))
    st_fin, centres = rec(st_in)
    feed = tuner_emit(spec, centres)
    return CF(feed.re.reshape(k_loc, s, t_loc),
              feed.im.reshape(k_loc, s, t_loc)), st_fin


def _decimate_with_halo(feed: CF, ds_tail: CF, mesh: Mesh, *, m: int):
    """Decimating 27-tap FIR over the sharded mixed-domain feed: the
    26-sample halo travels the ring; shard 0 uses the carried tail.
    Returns (ds [K, S, t_loc/m], the new carried tail [S, 26])."""
    n_tail = len(B.DS_FILTER) - 1
    is0 = (mesh.axis_index("sp") == 0)[:, None, None]
    pre = CF(*(torch.where(is0, tail[None], mesh.ring(x[..., -n_tail:], "sp"))
               for x, tail in ((feed.re, ds_tail.re), (feed.im, ds_tail.im))))
    ds, _ = polyphase_decimate(feed, B._ds_taps(feed.re.device), m, pre,
                               gain=B.HOWARD_FUDGE_FACTOR)
    new_tail = CF(mesh.from_last(feed.re[..., -n_tail:], "sp"),
                  mesh.from_last(feed.im[..., -n_tail:], "sp"))
    return ds, new_tail


def _fill_batched(vi: torch.Tensor, vq: torch.Tensor, on: torch.Tensor):
    """Log-shift last-valid fill along the last axis: (yi, yq, filled),
    the inclusive fill with no seed applied."""
    n = on.shape[-1]
    yi = torch.where(on, vi, 0.0)
    yq = torch.where(on, vq, 0.0)
    filled = on
    s = 1
    while s < n:
        def shift(a):
            return F.pad(a, (s, 0))[..., :n]
        yi = torch.where(filled, yi, shift(yi))
        yq = torch.where(filled, yq, shift(yq))
        filled = filled | shift(filled)
        s *= 2
    return yi, yq, filled


def _sync_correlate_slice(w: torch.Tensor, q0: int, n_q: int) -> torch.Tensor:
    """Sync correlation for the candidate starts j in [80*q0, 80*(q0+n_q))
    only: corr[j] = sum_n w[j + 80n] * SYNC[n]. w: [S, L] float with
    L >= 80*(q0 + n_q + 64). Returns [S, 80*n_q] int32 (sums of +-1,
    exact)."""
    seg = w[:, 80 * q0:80 * (q0 + n_q + 64)]
    corr = F.conv1d(seg[:, None, :], B._sync_taps(w.device), dilation=80)
    return corr[:, 0].to(torch.int32)


def _place_segments(bits_g: torch.Tensor, n_g: torch.Tensor,
                    max_bits: int) -> torch.Tensor:
    """The global compacted bit stream from per-shard compacted segments:
    segment j's first n_g[j] bits land at offset sum_{i<j} n_i.
    bits_g: [n_sp, S, mb_loc] i8, n_g: [n_sp, S]. Returns [S, max_bits]
    i8, zero past the total (a scatter; the reference's one-hot matmul
    gives the same values)."""
    n_sp, s, mb_loc = bits_g.shape
    n_g = n_g.long()
    off = torch.cumsum(n_g, dim=0) - n_g                    # exclusive
    i = torch.arange(mb_loc, device=bits_g.device)
    dest = off[..., None] + i
    live = (i < n_g[..., None]) & (dest < max_bits)
    dest = torch.where(live, dest, max_bits)                # spare column
    out = torch.zeros((s, max_bits + 1), dtype=bits_g.dtype,
                      device=bits_g.device)
    out.scatter_(1, dest.permute(1, 0, 2).reshape(s, -1),
                 torch.where(live, bits_g, 0).permute(1, 0, 2).reshape(s, -1))
    return out[:, :max_bits]


def _tail_sharded(ds: CF, states: B.BpskState, tu_phase, ds_tail: CF,
                  ft_state: FftTunerState, mesh: Mesh, *, max_hits: int,
                  t_total: int):
    """sp-sharded decode tail (FUNcubeBPSKDemod.java:505-595 + sync and
    extraction at scale). ds: [K, S, t_ds_loc]. Outputs and carried state
    are replicated over sp (no shard axis)."""
    p = B.SAMPLES_PER_BIT
    k_loc, s, t_ds_loc = ds.shape
    n_sp = mesh.shape["sp"]
    g_loc = t_ds_loc // p
    if t_ds_loc % p or g_loc < 2:
        raise ValueError("the sharded tail needs >= 2 whole bit groups per "
                         "shard")
    t_ds_total = t_ds_loc * n_sp
    dev = ds.re.device
    k = mesh.axis_index("sp")
    kk = k[:, None]
    is0 = kk == 0

    # ---- VCO mix at exact global positions -------------------------------
    vco0 = (states.vco_idx.long()[None] + kk * (t_ds_loc % p)) % p
    bb, _ = B._vco_mix(CF(ds.re.reshape(k_loc * s, -1),
                          ds.im.reshape(k_loc * s, -1)), vco0.reshape(-1))
    bb = CF(bb.re.reshape(k_loc, s, -1), bb.im.reshape(k_loc, s, -1))
    vco_out = ((states.vco_idx.long() + t_ds_total % p) % p).to(torch.int32)

    # ---- matched filter with a 64-sample ring halo ------------------------
    n_mf = len(B.DM_FILTER) - 1
    mf_pre = CF(*(torch.where(is0[..., None], tail[None],
                              mesh.ring(x[..., -n_mf:], "sp"))
                  for x, tail in ((bb.re, states.mf_tail.re),
                                  (bb.im, states.mf_tail.im))))
    mf, _ = fir_apply_streaming(bb, B._mf_taps(dev), mf_pre)
    mf_tail_out = CF(mesh.from_last(bb.re[..., -n_mf:], "sp"),
                     mesh.from_last(bb.im[..., -n_mf:], "sp"))

    # ---- bit-energy EMA: affine cross-shard resolution -------------------
    fi = mf.re.reshape(k_loc, s, g_loc, p)
    fq = mf.im.reshape(k_loc, s, g_loc, p)
    e1 = fi * fi + fq * fq
    a = 1.0 - B.BIT_SMOOTH1
    traj0 = B._const_ema_trajectory(e1 * B.BIT_SMOOTH1, a,
                                    torch.zeros((k_loc, s, p), device=dev))
    b_ends = mesh.all_gather(traj0[..., -1, :], "sp")       # [n_sp, S, 8]
    pw_tbl = torch.as_tensor(
        np.power(a, g_loc * np.arange(n_sp + 1)).astype(np.float32),
        device=dev)
    ema_in = pw_tbl[k][:, None, None] * states.timing.e_ema[None]
    for j in range(n_sp - 1):                               # j < k adds
        wgt = torch.where(j < k, pw_tbl[(k - 1 - j).clamp(0, n_sp)], 0.0)
        ema_in = ema_in + wgt[:, None, None] * b_ends[j][None]
    pw_g = torch.as_tensor(
        np.power(a, np.arange(1, g_loc + 1)).astype(np.float32), device=dev)
    traj = traj0 + pw_g[:, None] * ema_in[:, :, None, :]    # [K, S, G, 8]
    e_ema_out = mesh.from_last(traj[..., -1, :], "sp")

    # ---- peak schedule with a 2-scalar left-boundary hop -----------------
    am = torch.argmax(traj, dim=-1)                          # first maximum
    recv = mesh.ring(torch.stack([am[..., -1], am[..., -2]], dim=-1), "sp")
    in_np = torch.where(is0, states.timing.new_peak.long()[None],
                        recv[..., 0])
    in_pk = torch.where(is0, states.timing.peak.long()[None], recv[..., 1])
    np0 = torch.cat([in_np[..., None], am[..., :-1]], dim=-1)
    peak0 = torch.cat([in_pk[..., None], np0[..., :-1]], dim=-1)
    h = (peak0 + 4) % p
    peak_out = mesh.from_last(np0[..., -1], "sp").to(torch.int32)
    new_peak_out = mesh.from_last(am[..., -1], "sp").to(torch.int32)

    # ---- slot extraction -------------------------------------------------
    slot_p = torch.stack([peak0, np0], dim=-1)               # [K, S, G, 2]
    n2 = 2 * g_loc
    on = torch.stack([peak0 <= h, np0 > h], dim=-1).reshape(k_loc, s, n2)
    vi, vq, e1s = (x.gather(-1, slot_p).reshape(k_loc, s, n2)
                   for x in (fi, fq, e1))

    # ---- last-valid chain: local fill + 3-scalar boundary resolution -----
    yi, yq, filled = _fill_batched(vi, vq, on)
    lvg = mesh.all_gather(torch.stack(
        [yi[..., -1], yq[..., -1], filled[..., -1].float()], dim=-1), "sp")
    li = states.timing.last_iq
    ci, cq = li[None, :, 0].expand(k_loc, s), li[None, :, 1].expand(k_loc, s)
    gi, gq = li[:, 0], li[:, 1]
    for j in range(n_sp):
        has_j = lvg[j, :, 2] > 0.5
        take = (j < kk) & has_j[None]
        ci = torch.where(take, lvg[j, :, 0][None], ci)
        cq = torch.where(take, lvg[j, :, 1][None], cq)
        gi = torch.where(has_j, lvg[j, :, 0], gi)            # global final
        gq = torch.where(has_j, lvg[j, :, 1], gq)
    prev_i = torch.cat([ci[..., None], torch.where(
        filled[..., :-1], yi[..., :-1], ci[..., None])], dim=-1)
    prev_q = torch.cat([cq[..., None], torch.where(
        filled[..., :-1], yq[..., :-1], cq[..., None])], dim=-1)
    di = -(prev_i * vi + prev_q * vq)
    dq = prev_i * vq - prev_q * vi
    e2 = torch.sqrt(di * di + dq * dq)
    valid = on & (e2 > B.ENERGY_GATE)
    bit = di < 0.0

    # ---- e_out: exact suffix-weighted composition ------------------------
    onf = on.float()
    cnt = onf.sum(dim=-1)
    log_d = float(np.float32(np.log1p(-B.BIT_SMOOTH2)))
    tail_cnt = cnt[..., None] - torch.cumsum(onf, dim=-1)
    contrib = torch.sum(onf * e1s * B.BIT_SMOOTH2
                        * torch.exp(tail_cnt * log_d), dim=-1)
    cc = mesh.all_gather(torch.stack([cnt, contrib], dim=-1), "sp")
    total = cc[:, :, 0].sum(dim=0)
    e_out = torch.exp(total * log_d) * states.timing.e_out
    after = total
    for j in range(n_sp):
        after = after - cc[j, :, 0]                          # emissions after j
        e_out = e_out + cc[j, :, 1] * torch.exp(after * log_d)
    timing_out = B.TimingState(
        e_ema=e_ema_out, pos=states.timing.pos, peak=peak_out,
        new_peak=new_peak_out, e_out=e_out,
        last_iq=torch.stack([gi, gq], dim=1))

    # ---- bit stream: compact locally, gather, place at global offsets ----
    mb_loc = n2 + 2
    bits_loc, n_loc = B._compact_bits(valid.reshape(k_loc * s, n2),
                                      bit.reshape(k_loc * s, n2), mb_loc)
    bits_g = mesh.all_gather(bits_loc.reshape(k_loc, s, mb_loc), "sp")
    n_g = mesh.all_gather(n_loc.reshape(k_loc, s), "sp")
    max_bits = 2 * (t_ds_total // p) + 2
    bits = _place_segments(bits_g, n_g, max_bits)
    n_bits = n_g.sum(dim=0).to(torch.int32)

    # ---- sync search sharded by candidate position -----------------------
    q_per = -(-max_bits // (80 * n_sp))
    w = torch.cat([states.ring, bits], dim=1)                # [S, w_len]
    w_len = w.shape[1]
    pad_cols = max(-(-w_len // 80), n_sp * q_per + 65)
    wf = F.pad(w.float(), (0, 80 * pad_cols - w_len))
    found = []
    for q0 in (int(v) * q_per for v in k.tolist()):
        corr = _sync_correlate_slice(wf, q0, q_per)
        j_g = 80 * q0 + torch.arange(80 * q_per, device=dev)
        hits = (corr >= B.SYNC_THRESHOLD) & (j_g[None] < n_bits[:, None])
        idx = B._first_k_indices(hits, max_hits)
        ok = idx >= 0
        pos = torch.where(ok, 80 * q0 + idx, -1)
        corr_sel = torch.where(ok, corr.gather(1, idx.clamp(min=0)), 0)
        starts = torch.clamp(torch.where(ok, pos, 0), 0, w_len - B.FEC_BITS)
        win = torch.where((B._extract_rows(w, starts, B.FEC_BITS) == 1)
                          & ok[..., None], 0xC0, 0x40).to(torch.uint8)
        found.append((pos, corr_sel, win))
    ring_new = B._extract_rows(w, n_bits[:, None], B.FEC_BITS - 1)[:, 0]

    # merge the per-shard hits (shard-major order is ascending position)
    pos_g, corr_g, win_g = (mesh.all_gather(torch.stack(x), "sp")
                            for x in zip(*found))
    nh = n_sp * max_hits
    pos_f = pos_g.permute(1, 0, 2).reshape(s, nh)
    corr_f = corr_g.permute(1, 0, 2).reshape(s, nh)
    win_f = win_g.permute(1, 0, 2, 3).reshape(s, nh, B.FEC_BITS)
    ok_f = pos_f >= 0
    sel = B._first_k_indices(ok_f, max_hits)
    sel_ok = sel >= 0
    sel_c = sel.clamp(0, nh - 1)
    windows = torch.where(
        sel_ok[..., None],
        win_f.gather(1, sel_c[..., None].expand(-1, -1, B.FEC_BITS)),
        0x40).to(torch.uint8)
    hit_corr = torch.where(sel_ok, corr_f.gather(1, sel_c), 0
                           ).to(torch.int32)
    n_hits = torch.clamp(ok_f.sum(dim=1), max=max_hits).to(torch.int32)

    counters = states.counters + torch.stack(
        [torch.full_like(n_bits, t_total), torch.full_like(n_bits, t_ds_total),
         n_bits, n_hits], dim=1)
    out = B.BpskBlockOut(
        windows=windows, hit_corr=hit_corr, n_hits=n_hits, bits=bits,
        n_bits=n_bits,
        energies=torch.stack([e_out, hit_corr.max(dim=1).values.float()],
                             dim=1))
    new_state = B.BpskState(tu_phase, ds_tail, vco_out, mf_tail_out,
                            timing_out, ring_new, counters, ft_state)
    return out, new_state


def _telemetry_local(iq: CF, states: B.BpskState, tu: torch.Tensor,
                     dofft: torch.Tensor, track_high: torch.Tensor,
                     mesh: Mesh, *, rate: int, max_hits: int,
                     compat_scan: bool, front_mode: str):
    """The step over this process's shards: the sharded front end, then
    the sharded (or, for compat_scan, gathered) decode tail.
    iq: [K, S, t_loc]."""
    k_loc, s, t_loc = iq.shape
    n_sp = mesh.shape["sp"]
    t_total = t_loc * n_sp
    m = rate // B.DOWN_SAMPLE_RATE
    sp = mesh.axis_index("sp")

    # ---- front end: the mixed-domain feed, locally ------------------------
    if front_mode in ("manual", "mixed"):
        feed = _front_manual_local(iq, states.tu_phase, tu, sp, rate=rate)
        tu_phase = B._nco_advance(states.tu_phase, tu, rate, t_total)
        ft_state = states.fft_tuner
    if front_mode in ("dofft", "mixed"):
        feed_f, ft_fin = _front_dofft_local(iq, states.fft_tuner, track_high,
                                            mesh, rate=rate)
        ft_last = tree_map(lambda x: mesh.from_last(x, "sp"), ft_fin)
    if front_mode == "dofft":
        feed, tu_phase, ft_state = feed_f, states.tu_phase, ft_last
    elif front_mode == "mixed":                # per-stream selection
        sel = dofft[None, :, None]
        feed = CF(torch.where(sel, feed_f.re, feed.re),
                  torch.where(sel, feed_f.im, feed.im))
        tu_phase = torch.where(dofft, states.tu_phase, tu_phase)
        ft_state = tree_map(lambda new, old: torch.where(dofft, new, old),
                            ft_last, states.fft_tuner)

    ds, ds_tail = _decimate_with_halo(feed, states.ds_tail, mesh, m=m)
    if not compat_scan:
        return _tail_sharded(ds, states, tu_phase, ds_tail, ft_state, mesh,
                             max_hits=max_hits, t_total=t_total)

    # compat_scan: the per-sample scan cannot shard over time — gather the
    # decimated stream and run the single-device tail
    full = CF(*(mesh.all_gather(x, "sp").permute(1, 0, 2).reshape(s, -1)
                for x in (ds.re, ds.im)))
    return B._post_batch(full, states, tu_phase, ds_tail, ft_state, t_total,
                         max_hits, compat_scan=True)


def valid_block_samples(rate: int, n_sp: int, dofft: bool = False,
                        target_seconds: float = 1.0) -> int:
    """Smallest-step valid [S, T] time length near ``target_seconds``
    for :func:`sharded_telemetry_step`: T must split into sp equal
    shards of t_loc samples with t_loc a multiple of 8*decim (one
    whole bit group per decimated 8-sample window) and at least two
    bit groups per shard; dofft streams additionally need whole 0.1 s
    FFT blocks per shard (t_loc % (rate//10) == 0,
    FUNcubeBPSKDemod.java:406-464's per-block analysis)."""
    m = rate // B.DOWN_SAMPLE_RATE
    unit = (rate // 10) if dofft else 8 * m
    t_loc_min = max(2 * 8 * m, unit)
    t_loc = max(t_loc_min,
                round(target_seconds * rate / (n_sp * unit)) * unit)
    return n_sp * t_loc


def _validate_sharded_shapes(s: int, t: int, dp: int, n_sp: int, rate: int,
                             any_dofft: bool) -> None:
    """Raise an actionable ValueError for off-contract [S, T] shapes
    (the reference's text, jsdr_tpu/parallel/sharded.py:542)."""
    m = rate // B.DOWN_SAMPLE_RATE
    msgs = []
    if s % dp:
        msgs.append(f"S={s} streams must be a multiple of dp={dp}")
    if t % n_sp:
        msgs.append(f"T={t} samples must split over sp={n_sp} shards")
    else:
        t_loc = t // n_sp
        if t_loc % (8 * m):
            msgs.append(
                f"per-shard length T/sp={t_loc} must be a multiple of "
                f"8*decim={8 * m} (whole decimated bit groups)")
        elif t_loc < 16 * m:
            msgs.append(
                f"per-shard length T/sp={t_loc} must cover >= 2 bit "
                f"groups (>= {16 * m} samples)")
        if any_dofft and t_loc % (rate // 10):
            msgs.append(
                f"dofft streams need whole 0.1 s blocks per shard: "
                f"T/sp={t_loc} must be a multiple of {rate // 10}")
    if msgs:
        raise ValueError(
            "sharded_telemetry_step: invalid input shape — "
            + "; ".join(msgs)
            + f". Valid T are multiples of sp*8*decim={n_sp * 8 * m}"
            + (f" and of sp*rate/10={n_sp * (rate // 10)} when any "
               "stream uses dofft" if any_dofft else "")
            + f" (e.g. T={valid_block_samples(rate, n_sp, any_dofft)}; "
              "see parallel.sharded.valid_block_samples).")


def _as_cf(x, device) -> CF:
    """CF of tensors (moved to ``device``) or host complex -> CF."""
    if isinstance(x, CF):
        return CF(*(torch.as_tensor(v, device=device) for v in x))
    return from_complex(x, device)


def _host_flags(v, s: int) -> np.ndarray:
    return np.broadcast_to(np.asarray(False if v is None else v, bool),
                           (s,)).copy()


def sharded_telemetry_step(mesh: Mesh, rate: int = 96000, max_hits: int = 4,
                           compat_scan: bool = False):
    """Build the sharded telemetry step with chained state.

    Returns fn(iq, states, tunings=None, dofft=None, track_high=None) ->
    (out: demod.bpsk.BpskBlockOut, new_states: demod.bpsk.BpskState)
    where iq is [S, T] (CF of tensors, or host complex) — on a mesh that
    spans processes, this process's part: its dp rows' streams and its
    sp columns' samples — states a batched ``bpsk_init_batch`` state of
    those streams on the mesh's device, ``tunings`` a host [S] array of
    per-stream NCO Hz (multiples of 0.1 Hz; default 12000 for every
    stream, as in the reference), and ``dofft``/``track_high`` host [S]
    bools selecting the FFT auto-tune front end per stream
    (FUNcube<n>-bpsk-dofft / -upper, FUNcubeBPSKDemod.java:97-99).
    Consecutive calls chain bit-exactly like ``bpsk_block_batch`` —
    frames straddling two calls are decoded. The decode tail is
    sp-sharded (module docstring); ``compat_scan=True`` gathers it.
    """
    n_sp = mesh.shape["sp"]
    k_loc = mesh.local_count("sp")
    dp_scale = mesh.shape["dp"] // mesh.local_count("dp")

    def run(iq, states: B.BpskState, tunings=None, dofft=None,
            track_high=None):
        iq = _as_cf(iq, mesh.device)
        s, t_here = iq.shape
        if tunings is None:
            tunings = np.full(s, 12000)
        tun = B.tunings_to_nu(tunings)
        if tun is None:
            raise ValueError("sharded path needs tunings in multiples of "
                             "0.1 Hz")
        if tun.shape[0] != s:
            raise ValueError(f"{tun.shape[0]} tunings for {s} streams")
        dofft_np, th_np = _host_flags(dofft, s), _host_flags(track_high, s)
        _validate_sharded_shapes(s * dp_scale, t_here * n_sp // k_loc,
                                 mesh.shape["dp"], n_sp, rate,
                                 bool(dofft_np.any()))
        if t_here % k_loc:
            raise ValueError(f"T={t_here} does not split over this "
                             f"process's {k_loc} sp shards")
        front_mode = ("dofft" if dofft_np.all()
                      else "mixed" if dofft_np.any() else "manual")
        dev = mesh.device

        def shards(x):
            return x.reshape(s, k_loc, t_here // k_loc).transpose(0, 1)

        return _telemetry_local(
            CF(shards(iq.re), shards(iq.im)), states,
            torch.as_tensor(tun, dtype=torch.int64, device=dev),
            torch.as_tensor(dofft_np, device=dev),
            torch.as_tensor(th_np, device=dev), mesh, rate=rate,
            max_hits=max_hits, compat_scan=compat_scan,
            front_mode=front_mode)

    return run


def sharded_spectrum(mesh: Mesh, rate: float, window: bool = True):
    """Batched FFT/PSD with blocks sharded over the whole mesh (pure DP:
    every block independent — fft.java's per-block transform at scale).
    fn(blocks [B, N]) -> SpectrumResult; on a mesh that spans processes,
    blocks are this process's rows."""

    def run(blocks):
        return spectrum_block(_as_cf(blocks, mesh.device), rate=rate,
                              window=window)

    return run
