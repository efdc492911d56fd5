"""The timing kernel's chunked decomposition (``_timing_chunked_ref``, the
plain mirror of ``csrc/timing.cu``) against the plain version
``timing_recover_ref``: all seven outputs ``torch.equal``, on the CPU.

Cases: chunks of 1, 7, the kernel's CHUNK_GROUPS and more groups than
the block; blocks of a whole number of chunks and not; one block and two
chained; BPSK-like input, noise only, and a crafted input with groups
that fire no slot (pk0 >= 4 and np0 <= (pk0 + 4) % 8), at the first
group of a chunk (group 0 through the state, and later groups through
energy spikes), so that with chunks of 1 a whole chunk fires nothing."""

import numpy as np
import pytest
import torch

from jsdr_tpu_torch.demod.bpsk import BIT_SMOOTH1, BIT_SMOOTH2, ENERGY_GATE
from jsdr_tpu_torch.ops.timing_kernel import (CHUNK_GROUPS,
                                              _timing_chunked_ref,
                                              timing_recover_ref)

KW = dict(smooth1=BIT_SMOOTH1, smooth2=BIT_SMOOTH2, gate=ENERGY_GATE)
NAMES = ("valid", "bit", "e_ema", "peak", "new_peak", "e_out", "last_iq")
S = 5
# groups (within each block) that the crafted input keeps from firing:
# 35 opens a chunk of 7, 128 and 256 open chunks of CHUNK_GROUPS
NO_FIRE_AT = (35, 128, 256)


def _state(rng, no_fire_first: bool):
    st = (rng.random((S, 8)).astype(np.float32) * 2e4,
          rng.integers(0, 8, S).astype(np.int32),
          rng.integers(0, 8, S).astype(np.int32),
          rng.random(S).astype(np.float32) * 100,
          rng.standard_normal((S, 2)).astype(np.float32) * 50)
    if no_fire_first:           # group 0: pk0 = 4, np0 = 0 <= h = 0
        st[1][:] = 4
        st[2][:] = 0
    return st


def _input(rng, kind: str, groups: int, blocks: int):
    t_ds = 8 * groups * blocks
    mfr = rng.standard_normal((S, t_ds)).astype(np.float32) * 30
    mfi = rng.standard_normal((S, t_ds)).astype(np.float32) * 30
    if kind == "bpsk":
        mfr += (150 * np.sign(rng.standard_normal((S, t_ds // 8))))\
            .repeat(8, axis=1).astype(np.float32)
    elif kind == "nofire":
        # the argmax at phase 4 two groups before each listed group and at
        # phase 0 one group before: each spike's energy 4x the one before,
        # so it takes the EMAs' maximum whatever came earlier
        energy = 1e8
        for b in range(blocks):
            for g in NO_FIRE_AT:
                for at, phase in ((g - 2, 4), (g - 1, 0)):
                    mfr[:, 8 * (b * groups + at) + phase] = np.sqrt(energy)
                    mfi[:, 8 * (b * groups + at) + phase] = 0.0
                    energy *= 4.0
    return mfr, mfi


CASES = [
    # (chunk, groups per block, input, chained blocks)
    (1, 300, "bpsk", 1),
    (1, 300, "nofire", 1),
    (7, 280, "bpsk", 1),                # a whole number of chunks
    (7, 300, "noise", 1),
    (7, 300, "nofire", 1),
    (7, 300, "bpsk", 2),
    (CHUNK_GROUPS, 2 * CHUNK_GROUPS, "bpsk", 1),
    (CHUNK_GROUPS, 300, "noise", 2),
    (CHUNK_GROUPS, 300, "nofire", 1),
    (CHUNK_GROUPS, 300, "nofire", 2),
    (CHUNK_GROUPS, 300, "bpsk", 2),
    (512, 300, "bpsk", 1),              # one chunk, shorter than the chunk
    (512, 300, "nofire", 2),
]


@pytest.mark.parametrize("chunk,groups,kind,blocks", CASES)
def test_chunked_mirror_equals_plain(rng, chunk, groups, kind, blocks):
    st = _state(rng, kind == "nofire")
    mfr, mfi = _input(rng, kind, groups, blocks)
    t_ds = 8 * groups
    sm = sp = tuple(torch.from_numpy(a) for a in st)
    n_valid = 0
    for b in range(blocks):
        x = (torch.from_numpy(mfr[:, b * t_ds:(b + 1) * t_ds].copy()),
             torch.from_numpy(mfi[:, b * t_ds:(b + 1) * t_ds].copy()))
        m = _timing_chunked_ref(*x, *sm, chunk=chunk, **KW)
        p = timing_recover_ref(*x, *sp, **KW)
        for name, got, want in zip(NAMES, m, p):
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert torch.equal(got, want), f"block {b}: {name} differs"
        n_valid += int(p[0].sum())
        sm, sp = m[2:], p[2:]
    assert 0 < n_valid < S * 2 * groups * blocks

    if kind == "nofire":
        # the crafted groups really fire nothing: the plain version's
        # state after the groups before one is that group's (pk0, np0)
        full = tuple(torch.from_numpy(a) for a in st)
        starts = [0] + [b * groups + g for b in range(blocks)
                        for g in NO_FIRE_AT]
        for g in starts:
            if g == 0:
                pk0, np0 = full[1], full[2]
            else:
                out = timing_recover_ref(torch.from_numpy(mfr[:, :8 * g]),
                                         torch.from_numpy(mfi[:, :8 * g]),
                                         *full, **KW)
                pk0, np0 = out[3], out[4]
            h = (pk0 + 4) % 8
            assert bool(((pk0 >= 4) & (np0 <= h)).all()), f"group {g} fires"


def test_chunk_fits_the_kernel():
    """The kernel runs one worker thread a group of a chunk, synchronised
    by a named barrier over whole warps, and takes at most 256 (the
    shared memory of one CTA)."""
    assert CHUNK_GROUPS % 32 == 0 and 32 <= CHUNK_GROUPS <= 256
