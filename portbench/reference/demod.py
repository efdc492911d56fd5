"""Plain reference of the FUNcube telemetry chain, for the benchmark's
``correct``: the semantics of FUNcubeBPSKDemod.java and FECDecoder.java as
the port runs them for a batch of demodulator tabs on one stream, written
straight from the equations in plain PyTorch (any device, any float dtype)
and numpy, with no kernel, no fusion and nothing of the program.

Per block of raw interleaved S16LE values, for every tab:

1. conversion: I, Q = s16 / 32767 (no DC correction);
2. the tuner mix: the exact phase numerators nu_k = (nu_0 + k * tu) mod
   (10 * rate) in 0.1 Hz units (k = 1 ... T), the 256-entry quantised
   sine table, and the reference's non-complex product mi = I * cos,
   mq = Q * sin (FUNcubeBPSKDemod.java:366-397);
3. the 27-tap decimating low-pass by m = rate / 9600 with its carried
   history, times 0.9 * 32768: output k is the sum over taps a of
   taps[a] * xp[(k + 1) m - 1 + 26 - a], xp = history ++ block (:466-492);
4. the 1200 Hz VCO mix, pi/4 a decimated sample (:515-516), and the
   65-tap matched filter with its history (:58-77);
5. bit timing: 8 energy EMAs (1/200), the first maximum of each 8-sample
   group, the delayed peak / new-peak hand-off, two emission slots a
   group, the differential decision against the previous emission with
   the energy gate 100, and the e_out EMA (1/800) (:505-595, in the
   slot form the port's ``timing_recover_ref`` documents);
6. the decisions as +/-1 bits, the sync correlation with the 65-bit sync
   vector at stride 80 over the last 5199 bits and this block's, the
   first ``max_hits`` starts at or above 45 (:556-564), their 5200-symbol
   soft windows (0xC0 / 0x40), and the carried 5199-bit ring;
7. the counters: raw samples, decimated samples, bits, sync hits, each a
   32-bit signed count that wraps, as Java's int does.

A drain decodes every hit of its blocks with :mod:`.ao40` in (block,
tab, hit) order, as ``TelemetryStage`` publishes them.

The reference runs in the dtype it is given: float64 for the reference,
bfloat16 for the control (every value rounded to bfloat16 after each
operation, the EMA coefficients included).
"""

from __future__ import annotations

import numpy as np
import torch

from . import ao40
from .ao40_tables import SYNC_VECTOR

DOWN_SAMPLE_RATE = 9600
SAMPLES_PER_BIT = 8
GAIN = 0.9 * 32768.0
BIT_SMOOTH1 = 1.0 / 200.0
BIT_SMOOTH2 = 1.0 / 800.0
ENERGY_GATE = 100.0
SYNC_THRESHOLD = 45
FEC_BITS = 5200
SYNC_STRIDE = 80
NU_SCALE = 10
TABLE = 256

# FUNcubeBPSKDemod.java:27-55, the 27-tap decimation low-pass
DS_TAPS = (
    -6.103515625000e-004, -1.220703125000e-004, +2.380371093750e-003,
    +6.164550781250e-003, +7.324218750000e-003, +7.629394531250e-004,
    -1.464843750000e-002, -3.112792968750e-002, -3.225708007813e-002,
    -1.617431640625e-003, +6.463623046875e-002, +1.502380371094e-001,
    +2.231445312500e-001, +2.518310546875e-001, +2.231445312500e-001,
    +1.502380371094e-001, +6.463623046875e-002, -1.617431640625e-003,
    -3.225708007813e-002, -3.112792968750e-002, -1.464843750000e-002,
    +7.629394531250e-004, +7.324218750000e-003, +6.164550781250e-003,
    +2.380371093750e-003, -1.220703125000e-004, -6.103515625000e-004,
)

# FUNcubeBPSKDemod.java:58-77, the 65-tap root-raised-cosine matched filter
MF_TAPS = (
    -0.0101130691, -0.0086975143, -0.0038246093, +0.0033563764,
    +0.0107237026, +0.0157790936, +0.0164594107, +0.0119213911,
    +0.0030315224, -0.0076488191, -0.0164594107, -0.0197184277,
    -0.0150109226, -0.0023082460, +0.0154712381, +0.0327423589,
    +0.0424493086, +0.0379940454, +0.0154712381, -0.0243701991,
    -0.0750320094, -0.1244834076, -0.1568500423, -0.1553748911,
    -0.1061032953, -0.0015013786, +0.1568500423, +0.3572048240,
    +0.5786381191, +0.7940228249, +0.9744923010, +1.0945250059,
    +1.1366117829, +1.0945250059, +0.9744923010, +0.7940228249,
    +0.5786381191, +0.3572048240, +0.1568500423, -0.0015013786,
    -0.1061032953, -0.1553748911, -0.1568500423, -0.1244834076,
    -0.0750320094, -0.0243701991, +0.0154712381, +0.0379940454,
    +0.0424493086, +0.0327423589, +0.0154712381, -0.0023082460,
    -0.0150109226, -0.0197184277, -0.0164594107, -0.0076488191,
    +0.0030315224, +0.0119213911, +0.0164594107, +0.0157790936,
    +0.0107237026, +0.0033563764, -0.0038246093, -0.0086975143,
    -0.0101130691,
)

STATE_KEYS = ("tu_phase", "ds_tail_re", "ds_tail_im", "vco_idx",
              "mf_tail_re", "mf_tail_im", "e_ema", "peak", "new_peak",
              "e_out", "last_iq", "ring", "counters")


def wrap32(x):
    """A count as the reference keeps it: a 32-bit signed integer that
    wraps (Java's int, FUNcubeBPSKDemod.java:219-228)."""
    return (x + 2**31) % 2**32 - 2**31


def fresh_state(n_tabs: int, device, dtype=torch.float64) -> dict:
    """The state of freshly started tabs: everything zero but e_out = 1."""
    def z(*shape, dt=dtype):
        return torch.zeros((n_tabs, *shape), dtype=dt, device=device)

    i64 = torch.int64
    return {"tu_phase": z(dt=i64), "ds_tail_re": z(len(DS_TAPS) - 1),
            "ds_tail_im": z(len(DS_TAPS) - 1), "vco_idx": z(dt=i64),
            "mf_tail_re": z(len(MF_TAPS) - 1),
            "mf_tail_im": z(len(MF_TAPS) - 1),
            "e_ema": z(SAMPLES_PER_BIT), "peak": z(dt=i64),
            "new_peak": z(dt=i64), "e_out": z() + 1.0, "last_iq": z(2),
            "ring": z(FEC_BITS - 1, dt=torch.int8),
            "counters": z(4, dt=i64)}


def _r(x: torch.Tensor, dtype) -> torch.Tensor:
    """Round to the reference's dtype (a no-op in float64)."""
    return x.to(dtype)


def _fir_decimate(xp_re, xp_im, taps, m: int, k_out: int, dtype):
    """sum_a taps[a] * xp[..., m - 1 + (n - 1) - a + k m], k < k_out."""
    n = len(taps)
    out_re = torch.zeros(xp_re.shape[:-1] + (k_out,), dtype=dtype,
                         device=xp_re.device)
    out_im = torch.zeros_like(out_re)
    for a, h in enumerate(taps):
        lo = m - 1 + (n - 1) - a
        sl = slice(lo, lo + m * (k_out - 1) + 1, m)
        hh = float(torch.tensor(h, dtype=dtype))
        out_re = _r(out_re + _r(hh * xp_re[..., sl], dtype), dtype)
        out_im = _r(out_im + _r(hh * xp_im[..., sl], dtype), dtype)
    return out_re, out_im


class Demod:
    """The reference chain for ``tunings`` (Hz, whole multiples of 0.1 Hz
    above 0) at ``rate``, on ``device`` in ``dtype``.

    :meth:`block` takes one block of raw int16 values and the state dict
    (:data:`STATE_KEYS`, as :func:`fresh_state` makes it) and returns the
    block's hits and the new state. Tabs are processed ``tab_chunk`` at a
    time up to the matched filter, so that a 4.8 s block at 192 kS/s
    fits."""

    def __init__(self, rate: int, tunings, max_hits: int, device,
                 dtype=torch.float64, tab_chunk: int = 16):
        if rate % DOWN_SAMPLE_RATE:
            raise ValueError(f"rate {rate} is not a multiple of 9600")
        self.rate, self.m = rate, rate // DOWN_SAMPLE_RATE
        tu = np.round(np.asarray(tunings, np.float64) * NU_SCALE)
        if not (np.allclose(tu / NU_SCALE, tunings) and (tu > 0).all()):
            raise ValueError("the reference takes tunings that are positive "
                             "multiples of 0.1 Hz")
        self.device, self.dtype = torch.device(device), dtype
        self.tu = torch.as_tensor(tu.astype(np.int64), device=self.device)
        self.n = len(tu)
        self.max_hits = max_hits
        self.tab_chunk = tab_chunk
        ang = np.arange(TABLE) * (2 * np.pi / TABLE)
        self.cos_tab = torch.as_tensor(np.cos(ang), device=self.device)
        self.sin_tab = torch.as_tensor(np.sin(ang), device=self.device)
        vang = ((np.arange(SAMPLES_PER_BIT) + 1) % SAMPLES_PER_BIT) * (
            2 * np.pi / SAMPLES_PER_BIT)
        self.vco_cos = torch.as_tensor(np.cos(vang), device=self.device)
        self.vco_sin = torch.as_tensor(np.sin(vang), device=self.device)
        self.sync = torch.as_tensor(np.asarray(SYNC_VECTOR, np.int64),
                                    device=self.device)

    # -- front end: conversion, tuner, decimator, VCO, matched filter --------

    def _front(self, raw: np.ndarray, st: dict):
        dt, dev, m = self.dtype, self.device, self.m
        raw = np.asarray(raw, np.int16)
        streams = raw.shape[0] if raw.ndim == 2 else 1
        if self.n % streams:
            raise ValueError(f"{self.n} tabs do not split over {streams} "
                             "streams")
        per_stream = self.n // streams
        iq = torch.as_tensor(raw.reshape(streams, -1, 2).astype(np.float64),
                             device=dev) / 32767.0
        i_in, q_in = _r(iq[..., 0], dt), _r(iq[..., 1], dt)
        t_len = i_in.shape[1]
        if t_len % (SAMPLES_PER_BIT * m):
            raise ValueError(f"block of {t_len} samples is not whole bit "
                             "periods of the decimated stream")
        k_out = t_len // m
        den = NU_SCALE * self.rate
        k = torch.arange(1, t_len + 1, dtype=torch.int64, device=dev)
        mf_re, mf_im = [], []
        new = {key: [] for key in ("ds_tail_re", "ds_tail_im", "mf_tail_re",
                                   "mf_tail_im")}
        gain = float(torch.tensor(GAIN, dtype=dt))
        for lo in range(0, self.n, self.tab_chunk):
            sel = slice(lo, lo + self.tab_chunk)
            tu = self.tu[sel]
            src = torch.arange(self.n, device=dev)[sel] // per_stream
            nums = (st["tu_phase"][sel, None] + k[None, :] * tu[:, None]) % den
            idx = nums * TABLE // den
            mi = _r(i_in[src] * _r(self.cos_tab[idx], dt), dt)
            mq = _r(q_in[src] * _r(self.sin_tab[idx], dt), dt)
            del nums, idx
            xr = torch.cat([st["ds_tail_re"][sel], mi], dim=1)
            xi = torch.cat([st["ds_tail_im"][sel], mq], dim=1)
            del mi, mq
            yr, yi = _fir_decimate(xr, xi, DS_TAPS, m, k_out, dt)
            yr, yi = _r(yr * gain, dt), _r(yi * gain, dt)
            new["ds_tail_re"].append(xr[:, -(len(DS_TAPS) - 1):])
            new["ds_tail_im"].append(xi[:, -(len(DS_TAPS) - 1):])
            del xr, xi
            ph = (st["vco_idx"][sel, None]
                  + torch.arange(k_out, device=dev)[None, :]) % SAMPLES_PER_BIT
            br = _r(yr * _r(self.vco_cos[ph], dt), dt)
            bi = _r(yi * _r(self.vco_sin[ph], dt), dt)
            xr = torch.cat([st["mf_tail_re"][sel], br], dim=1)
            xi = torch.cat([st["mf_tail_im"][sel], bi], dim=1)
            fr, fi = _fir_decimate(xr, xi, MF_TAPS, 1, k_out, dt)
            mf_re.append(fr)
            mf_im.append(fi)
            new["mf_tail_re"].append(xr[:, -(len(MF_TAPS) - 1):])
            new["mf_tail_im"].append(xi[:, -(len(MF_TAPS) - 1):])
        out = {key: torch.cat(v) for key, v in new.items()}
        out["tu_phase"] = (st["tu_phase"] + (t_len % den) * self.tu) % den
        out["vco_idx"] = (st["vco_idx"] + k_out) % SAMPLES_PER_BIT
        return torch.cat(mf_re), torch.cat(mf_im), out, t_len, k_out

    # -- bit timing ---------------------------------------------------------

    def _timing(self, mf_re, mf_im, st: dict):
        dt = self.dtype
        s, t_ds = mf_re.shape
        g = t_ds // SAMPLES_PER_BIT
        s1 = float(torch.tensor(BIT_SMOOTH1, dtype=dt))
        a1 = float(torch.tensor(1.0 - BIT_SMOOTH1, dtype=dt))
        s2 = float(torch.tensor(BIT_SMOOTH2, dtype=dt))
        a2 = float(torch.tensor(1.0 - BIT_SMOOTH2, dtype=dt))
        fi = mf_re.reshape(s, g, SAMPLES_PER_BIT)
        fq = mf_im.reshape(s, g, SAMPLES_PER_BIT)
        e1 = _r(_r(fi * fi, dt) + _r(fq * fq, dt), dt)
        b = _r(e1 * s1, dt)
        traj = torch.empty_like(e1)
        ema = st["e_ema"]
        for k in range(g):
            ema = _r(_r(ema * a1, dt) + b[:, k], dt)
            traj[:, k] = ema
        am = torch.argmax(traj, dim=2)          # the first maximum
        np0 = torch.cat([st["new_peak"][:, None], am[:, :-1]], dim=1)
        pk0 = torch.cat([st["peak"][:, None], np0[:, :-1]], dim=1)
        half = (pk0 + 4) % SAMPLES_PER_BIT
        slot = torch.stack([pk0, np0], dim=-1)
        on = torch.stack([pk0 <= half, np0 > half], dim=-1).reshape(s, 2 * g)
        vi = fi.gather(2, slot).reshape(s, 2 * g)
        vq = fq.gather(2, slot).reshape(s, 2 * g)
        e1s = e1.gather(2, slot).reshape(s, 2 * g)
        pos = torch.arange(2 * g, device=mf_re.device).expand(s, -1)
        last_on = torch.where(on, pos, -1).cummax(dim=1).values
        prev = torch.cat([last_on.new_full((s, 1), -1), last_on[:, :-1]],
                         dim=1)
        have = prev >= 0
        at = prev.clamp(min=0)
        pi = torch.where(have, vi.gather(1, at), st["last_iq"][:, :1])
        pq = torch.where(have, vq.gather(1, at), st["last_iq"][:, 1:])
        di = -_r(_r(pi * vi, dt) + _r(pq * vq, dt), dt)
        dq = _r(_r(pi * vq, dt) - _r(pq * vi, dt), dt)
        e2 = _r(torch.sqrt(_r(_r(di * di, dt) + _r(dq * dq, dt), dt)), dt)
        valid = on & (e2 > ENERGY_GATE)
        bit = di < 0
        eo = st["e_out"]
        contrib = _r(e1s * s2, dt)
        for k in range(2 * g):
            eo = torch.where(on[:, k], _r(_r(eo * a2, dt) + contrib[:, k], dt),
                             eo)
        fin = last_on[:, -1:]
        fired = fin >= 0
        fin = fin.clamp(min=0)
        last_iq = torch.where(fired, torch.cat([vi.gather(1, fin),
                                                vq.gather(1, fin)], dim=1),
                              st["last_iq"])
        return valid, bit, {"e_ema": ema, "peak": np0[:, -1],
                            "new_peak": am[:, -1], "e_out": eo,
                            "last_iq": last_iq}

    # -- bits, sync search, windows -----------------------------------------

    def _frames(self, valid, bit, ring, t_ds: int):
        s = valid.shape[0]
        dev = valid.device
        max_bits = 2 * (t_ds // SAMPLES_PER_BIT) + 2
        n_valid = valid.sum(dim=1)
        n_bits = torch.clamp(n_valid, max=max_bits)
        bits = torch.zeros((s, max_bits), dtype=torch.int8, device=dev)
        rank = torch.cumsum(valid.to(torch.int64), dim=1) - 1
        keep = valid & (rank < max_bits)
        rows = torch.arange(s, device=dev)[:, None].expand_as(valid)
        bits[rows[keep], rank[keep]] = torch.where(bit[keep], 1, -1).to(
            torch.int8)
        w = torch.cat([ring, bits], dim=1).to(torch.int64)
        corr = torch.zeros((s, max_bits), dtype=torch.int64, device=dev)
        for j in range(len(SYNC_VECTOR)):
            corr += self.sync[j] * w[:, j * SYNC_STRIDE:
                                     j * SYNC_STRIDE + max_bits]
        pos = torch.arange(max_bits, device=dev)
        hits = (corr >= SYNC_THRESHOLD) & (pos[None, :] < n_bits[:, None])
        windows, hit_corr, hit_tab = [], [], []
        hits_h, corr_h = hits.cpu().numpy(), corr.cpu().numpy()
        w_h = w.cpu().numpy()
        n_hits = np.zeros(s, np.int64)
        for tab in range(s):
            for start in np.nonzero(hits_h[tab])[0][:self.max_hits]:
                windows.append(np.where(w_h[tab, start:start + FEC_BITS] == 1,
                                        0xC0, 0x40).astype(np.uint8))
                hit_corr.append(int(corr_h[tab, start]))
                hit_tab.append(tab)
                n_hits[tab] += 1
        span = torch.arange(FEC_BITS - 1, device=dev)
        new_ring = w.gather(1, n_bits[:, None] + span[None, :]).to(torch.int8)
        return windows, hit_corr, hit_tab, n_hits, n_bits, new_ring

    def block(self, raw: np.ndarray, st: dict):
        """One block for every tab: returns (hits, new state), hits a dict
        of ``windows`` (list of [5200] uint8), ``corr`` and ``tab`` in
        (tab, hit) order. ``raw`` is one stream's block, which every tab
        reads, or [G, ...] the blocks of G streams, the tabs split over
        them in order (tab i reads stream i // (tabs / G)): independent
        runs of the same tab set batched as rows."""
        mf_re, mf_im, new, t_len, t_ds = self._front(raw, st)
        valid, bit, timing = self._timing(mf_re, mf_im, st)
        del mf_re, mf_im
        windows, corr, tab, n_hits, n_bits, ring = self._frames(
            valid, bit, st["ring"], t_ds)
        new.update(timing)
        new["ring"] = ring
        inc = torch.stack([torch.full_like(n_bits, t_len),
                           torch.full_like(n_bits, t_ds), n_bits,
                           torch.as_tensor(n_hits, device=n_bits.device)],
                          dim=1)
        new["counters"] = wrap32(st["counters"] + inc)
        return {"windows": windows, "corr": corr, "tab": tab}, new


def decode_drain(hits_of_blocks) -> list[tuple]:
    """The frames a drain publishes for its blocks' hits, in (block, tab,
    hit) order: (tab, ok, corr, rc, payload bytes) each."""
    windows, corr, tab = [], [], []
    for h in hits_of_blocks:
        windows += h["windows"]
        corr += h["corr"]
        tab += h["tab"]
    if not windows:
        return []
    payload, ok, rc = ao40.decode_batch(np.stack(windows))
    return [(int(t), bool(o), int(c), int(r), p.tobytes())
            for t, o, c, r, p in zip(tab, ok, corr, rc, payload)]
