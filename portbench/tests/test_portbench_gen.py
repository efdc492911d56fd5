"""The traffic generator: the same seed gives the same capture, another
seed another; the loop closes at its seam; the capture refuses to clip;
and its frames decode through the plain reference at a small size."""

import numpy as np
import pytest
import torch

from portbench.gen.synth import FRAME_SYMBOLS, make_capture
from portbench.reference import ao40, demod

RATE = 96000
SEED = 2**31 + 4242


def small(seed, carriers=(6000, 12000), periods=3, amp=0.2, noise=0.04):
    return make_capture(RATE, carriers, amp, noise, periods, seed, "cpu")


def test_deterministic_per_seed():
    a, b, c = small(SEED), small(SEED), small(SEED + 1)
    assert np.array_equal(a.raw, b.raw)
    assert np.array_equal(a.payloads, b.payloads)
    assert not np.array_equal(a.raw, c.raw)
    assert not np.array_equal(a.payloads, c.payloads)


def test_capture_layout():
    cap = small(SEED)
    sps = RATE // 1200
    period = FRAME_SYMBOLS * sps
    assert cap.n_samples == 3 * period
    assert len({p.tobytes() for p in cap.payloads}) == len(cap.payloads) == 6
    # carrier 1's frames start half a period after carrier 0's
    assert sorted(cap.last_sample % period) == sorted(
        [period - 1] * 3 + [period // 2 - 1] * 3)
    chunks = cap.chunks(RATE // 10)
    assert all(c.dtype == np.int16 and c.shape == (2 * RATE // 10,)
               for c in chunks)


def test_each_carrier_loop_closes():
    """An even number of phase flips a loop: the differential phase
    returns to where it started, so the looped stream has no seam."""
    cap = small(SEED, carriers=(6000,), periods=3)
    syms = ao40.encode_batch(cap.payloads).reshape(-1)
    assert (syms == 0).sum() % 2 == 0


def test_refuses_to_clip():
    with pytest.raises(ValueError, match="clips"):
        small(SEED, carriers=(6000, 12000, 18000), periods=1, amp=0.4)


def test_frames_decode_through_the_reference():
    """Two loops of a one-carrier capture (3 frames) through the reference chain at
    the carrier's tuning: every payload sent decodes, bit-exact."""
    cap = small(SEED, carriers=(12000,), noise=0.02)
    dem = demod.Demod(RATE, [12000.0, 12750.0], 4, "cpu", torch.float64)
    st = demod.fresh_state(2, "cpu")
    flat = cap.raw.reshape(-1)
    hits = []
    for loop in range(2):
        for b in range(cap.n_samples // RATE):
            h, st = dem.block(flat[2 * b * RATE:2 * (b + 1) * RATE], st)
            hits.append(h)
    frames = demod.decode_drain(hits)
    good = {(f[0], f[4]) for f in frames if f[1]}
    assert {(0, p.tobytes()) for p in cap.payloads} <= good
    assert all(0 <= f[3] < 260 for f in frames if f[1] and f[0] == 0)
