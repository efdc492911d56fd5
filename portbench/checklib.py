"""The comparisons that decide ``correct``, shared by the stage checks
(``checks/<StageClass>.py``).

Each check replays the groups the run kept (``harness.Group``: the raw
blocks of one drain's worth of blocks, the telemetry stage's state before
them, what the Session published for them) through the plain reference
in float64, and compares with it what the program published, or, for the
control, what the reference computed in bfloat16 publishes. Each returns
plain numbers; the cell's limits file holds their limits.

The start's groups (the warm-up and the window's first groups) run in
order from the reference's own fresh state, which the reference carries
from group to group. Each sampled later group runs from the program's
state before it: the reference follows the program from there, and the
parts of that state that follow from the block count alone (the sample
counters, the tuner's phase, the VCO's index) are checked against the
count (``skipped_state_diff``). The sampled groups run batched, each
group's tabs as rows of one reference run.

Beside the replays, :func:`frames_missed` holds every drain of the
window to the frames the capture sent.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from .reference import demod as D

FLOAT_KEYS = ("ds_tail_re", "ds_tail_im", "mf_tail_re", "mf_tail_im",
              "e_ema", "e_out", "last_iq")


def ref_state(snap: dict | None, n_tabs: int, dev, dtype) -> dict:
    """The reference's state dict from the program's (None: fresh)."""
    if snap is None:
        return D.fresh_state(n_tabs, dev, dtype)
    out = {}
    for k in D.STATE_KEYS:
        v = snap[k].to(dev)
        if k in FLOAT_KEYS:
            out[k] = v.to(dtype)
        elif k == "tu_phase":
            out[k] = torch.round(v.double()).to(torch.int64)
        elif k == "ring":
            out[k] = v.to(torch.int8)
        else:
            out[k] = v.to(torch.int64)
    return out


def replay(demod: D.Demod, raws, st: dict):
    """A group's blocks through the reference: (frames of its drain,
    state after it). ``raws`` are the blocks, each one stream's or
    [G, ...] G streams' (``Demod.block``)."""
    hits = []
    for raw in raws:
        h, st = demod.block(raw, st)
        hits.append(h)
    return D.decode_drain(hits), st


def _cat_states(states: list) -> dict:
    return {k: torch.cat([s[k] for s in states]) for k in states[0]}


def skipped_state_diff(snap: dict, first_block: int, block_samples: int,
                       rate: int, tunings) -> int:
    """Mismatches between the program's state before ``first_block`` and
    what the block count alone fixes: raw and decimated sample counters,
    the tuner's phase numerator and the VCO's index."""
    m = rate // D.DOWN_SAMPLE_RATE
    den = D.NU_SCALE * rate
    raw_n = first_block * block_samples
    tu = np.round(np.asarray(tunings, np.float64) * D.NU_SCALE).astype(
        np.int64)
    c = snap["counters"].cpu().numpy().astype(np.int64)
    phase = np.round(snap["tu_phase"].double().cpu().numpy()).astype(np.int64)
    vco = snap["vco_idx"].cpu().numpy().astype(np.int64)
    return int((c[:, 0] != D.wrap32(raw_n)).sum()
               + (c[:, 1] != D.wrap32(raw_n // m)).sum()
               + (phase != (raw_n % den) * tu % den).sum()
               + (vco != (raw_n // m) % D.SAMPLES_PER_BIT).sum())


def counters_array(published: dict, n_tabs: int) -> np.ndarray:
    return np.asarray([published[s] for s in range(n_tabs)], np.int64)


def telemetry_numbers(params: dict, start, sampled, dev,
                      control: bool) -> dict:
    """Frames and counters of every checked group's drain.

    - ``frames_diff``: good frames (ok) that one side published and the
      other did not, matched by tab and payload (a multiset difference);
    - ``frame_field_gap``: over matched good frames, the largest
      difference in sync correlation or channel errors (rc);
    - ``hits_diff``: the sum over tabs of the difference in sync hits
      (every hit reaches the drain, good frame or not);
    - ``bits_gap``: the largest difference in a tab's decided bits;
    - ``count_diff``: raw and decimated sample counts that differ, plus
      the sampled groups' ``skipped_state_diff``."""
    tun, rate, hits = params["tunings"], params["rate"], params["max_hits"]
    n = len(tun)
    out = dict(frames_diff=0, frame_field_gap=0, hits_diff=0, bits_gap=0,
               count_diff=0)
    # the start: in order, the reference carrying its own state
    ref = D.Demod(rate, tun, hits, dev, torch.float64)
    cand = D.Demod(rate, tun, hits, dev, torch.bfloat16) if control else None
    st = D.fresh_state(n, dev, torch.float64)
    cst = D.fresh_state(n, dev, torch.bfloat16) if control else None
    for g in start:
        c0 = st["counters"].cpu().numpy()
        r_frames, st = replay(ref, g.raw, st)
        if control:
            frames, cst = replay(cand, g.raw, cst)
            count = cst["counters"].cpu().numpy()
        else:
            frames, count = g.frames, counters_array(g.counters, n)
        _compare(out, frames, count, r_frames,
                 st["counters"].cpu().numpy(), c0)
    if not sampled:
        return out
    # the sampled groups: batched, each from the program's state before it
    for g in sampled:
        out["count_diff"] += skipped_state_diff(
            g.state, g.first_block, params["block_samples"], rate, tun)
    rows = list(tun) * len(sampled)
    raws = [np.stack([g.raw[i] for g in sampled])
            for i in range(sampled[0].size)]
    st = _cat_states([ref_state(g.state, n, dev, torch.float64)
                      for g in sampled])
    c0 = st["counters"].cpu().numpy()
    r_frames, st = replay(D.Demod(rate, rows, hits, dev, torch.float64),
                          raws, st)
    r_count = st["counters"].cpu().numpy()
    if control:
        cst = _cat_states([ref_state(g.state, n, dev, torch.bfloat16)
                           for g in sampled])
        c_frames, cst = replay(D.Demod(rate, rows, hits, dev,
                                       torch.bfloat16), raws, cst)
        c_count = cst["counters"].cpu().numpy()
    for j, g in enumerate(sampled):
        mine = slice(j * n, (j + 1) * n)
        if control:
            frames, count = _of_group(c_frames, j, n), c_count[mine]
        else:
            frames, count = g.frames, counters_array(g.counters, n)
        _compare(out, frames, count, _of_group(r_frames, j, n),
                 r_count[mine], c0[mine])
    return out


def _of_group(frames, j: int, n: int) -> list:
    """The frames of batched group ``j`` (rows j n ... j n + n - 1), with
    their tab numbers within the group."""
    return [(f[0] - j * n,) + f[1:] for f in frames if f[0] // n == j]


def _compare(out: dict, frames, count, r_frames, r_count, c0) -> None:
    """Add one group's differences to ``out``: the program's (or the
    control's) frames and counters after the group against the
    reference's, both from counters ``c0`` before it."""
    d_got, d_ref = D.wrap32(count - c0), D.wrap32(r_count - c0)
    out["count_diff"] += int((d_got[:, :2] != d_ref[:, :2]).sum())
    out["bits_gap"] = max(out["bits_gap"],
                          int(np.abs(d_got[:, 2] - d_ref[:, 2]).max()))
    out["hits_diff"] += int(np.abs(d_got[:, 3] - d_ref[:, 3]).sum())
    got_ok = Counter((f[0], f[4]) for f in frames if f[1])
    ref_ok = Counter((f[0], f[4]) for f in r_frames if f[1])
    out["frames_diff"] += sum(((got_ok - ref_ok) + (ref_ok - got_ok))
                              .values())
    fields = {}
    for f in r_frames:
        if f[1]:
            fields.setdefault((f[0], f[4]), []).append((f[2], f[3]))
    for f in frames:
        if f[1] and fields.get((f[0], f[4])):
            corr, rc = fields[(f[0], f[4])].pop(0)
            out["frame_field_gap"] = max(out["frame_field_gap"],
                                         abs(f[2] - corr),
                                         abs(f[3] - rc))


def frames_missed(drains, cap, tunings, block_samples: int,
                  first_block: int) -> int:
    """Every frame the capture sent on a tab's tuning in the window,
    against the good frames the window's drains published (drains after
    block ``first_block``, the window's first): the sent frames whose last
    sample falls in a block from ``first_block`` up to the block before
    the last drain's (their sync completes by that drain) and that were
    not published good with their payload by the tab tuned to their
    carrier, plus the good frames published whose payload was never sent.
    A multiset count over (tab, payload): the looped capture sends each
    payload once a loop."""
    window = [d for d in drains if d.block >= first_block]
    if not window:
        return 0
    got = Counter((t, p) for d in window for t, ok, p in d.frames if ok)
    lo = first_block * block_samples
    hi = max(d.block for d in window) * block_samples
    n = cap.n_samples
    want = Counter()
    for pay, carrier, last in zip(cap.payloads, cap.carrier,
                                  cap.last_sample):
        times = max(0, -((int(last) - hi) // n) + ((int(last) - lo) // n))
        for t, f in enumerate(tunings):
            if times and abs(f - carrier) < 0.5:
                want[(t, pay.tobytes())] += times
    sent = {p.tobytes() for p in cap.payloads}
    unsent = sum(c for (_, p), c in got.items() if p not in sent)
    return sum((want - got).values()) + unsent


def group_block(g, topic: str, offset: int):
    """What the Session published on ``topic`` during the group's block
    ``offset`` (0 ... size-1), or None."""
    for b, v in g.per_block.get(topic, []):
        if b == g.first_block + offset:
            return v
    return None


def cast_u8(inten: torch.Tensor) -> torch.Tensor:
    """A line's intensity truncated to 8 bits, as the program stores it."""
    return torch.floor(inten).clamp(0, 255)
