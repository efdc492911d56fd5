"""Kernel 6's walk (``csrc/mix_dec_mf.cu``), rehearsed on the CPU through
its plain mirror ``ops/mix_decimate_mf.py::_mix_dec_mf_walk``: spans of a
stream's outputs, each from its own 64 decimated samples of halo (the
first from the carried mf tail), sub-chunks whose input sits in a
polyphase layout, bb in 4 rows for the 4 outputs a thread forms, matched
filter passes of 1024 with the 64-sample halo carried between them, and
ragged last sub-chunks, passes and spans. It must equal
``mix_decimate_mf_ref`` (the unfused chain) bit for bit on all three
outputs, at m = 10 and 20 with spans and sub-chunks that do not divide the
block, at the generic m the kernel takes with smaller sub-chunks, with a
span of one output, and with fewer outputs than the mf halo.
chip_smoke.py phase 10 holds the CUDA kernel against the plain version on
the card."""

import numpy as np
import pytest
import torch

from jsdr_tpu_torch.demod.bpsk import (DM_FILTER, DS_FILTER,
                                       HOWARD_FUDGE_FACTOR, _vco_pattern)
from jsdr_tpu_torch.ops.cplx import CF
from jsdr_tpu_torch.ops.mix_decimate_mf import (_mix_dec_mf_walk,
                                                mix_decimate_mf_ref)


def _args(seed, s, t, m):
    rng = np.random.default_rng(seed)
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh)
                                     .astype(np.float32))
    ang = (np.arange(128) * 3 % 128) * (2 * np.pi / 128)
    cs = torch.from_numpy(np.tile(np.cos(ang).astype(np.float32), (s, 1)))
    sn = torch.from_numpy(np.tile(np.sin(ang).astype(np.float32), (s, 1)))
    vc, vs = _vco_pattern(torch.from_numpy(rng.integers(0, 8, s)
                                           .astype(np.int32)))
    return (CF(0.3 * f(s, t), 0.3 * f(s, t)), cs, sn,
            torch.as_tensor(DS_FILTER, dtype=torch.float32), m,
            CF(f(s, 26), f(s, 26)), vc, vs,
            torch.as_tensor(DM_FILTER, dtype=torch.float32),
            CF(f(s, 64), f(s, 64)), HOWARD_FUDGE_FACTOR)


# (streams, samples, m, span, sub): 96 k and 192 k with spans that do not
# divide the block (ragged passes and sub-chunks), one span, spans shorter
# than a pass, a last span of one output, kernel 1's ragged 13 x 95,440
# shape (3 streams of it), generic m with 32- and 64-sample sub-chunks and
# with the sub-chunks the kernel takes at m = 40 (128) and 100 (32: a
# thread stages at most 21 samples a plane), and 40 outputs (fewer than
# the 64-sample mf halo)
CASES = [(3, 26240, 10, 700, 256), (2, 52480, 20, 1000, 256),
         (3, 26240, 10, 2624, 256), (2, 26240, 10, 96, 32),
         (3, 26240, 10, 2623, 256), (3, 95440, 10, 3200, 256),
         (2, 10500, 7, 512, 64), (2, 13000, 13, 333, 32),
         (2, 60000, 40, 700, 128), (2, 70000, 100, 512, 32),
         (2, 400, 10, 512, 256)]


@pytest.mark.parametrize("s,t,m,span,sub", CASES)
def test_walk_equals_plain(s, t, m, span, sub):
    args = _args(s * t + m + span, s, t, m)
    got = _mix_dec_mf_walk(*args, span=span, sub=sub)
    want = mix_decimate_mf_ref(*args)
    for g, w in zip(got, want):
        assert g.re.shape == w.re.shape
        assert torch.equal(g.re, w.re) and torch.equal(g.im, w.im)


def test_walk_chained_half_blocks_equal_one_block():
    """Two chained half blocks (patterns rolled on by the first half's
    length, as the demodulator's state advances them) equal one whole
    block, bit for bit: what chip_smoke.py phase 10 holds the kernel to."""
    s, t, m = 2, 25600, 10
    args = list(_args(5, s, t, m))
    whole = _mix_dec_mf_walk(*args, span=900)
    half, hd = t // 2, t // 2 // m
    x = args[0]
    first = list(args)
    first[0] = CF(x.re[:, :half].contiguous(), x.im[:, :half].contiguous())
    a = _mix_dec_mf_walk(*first, span=900)
    second = list(args)
    second[0] = CF(x.re[:, half:].contiguous(), x.im[:, half:].contiguous())
    second[1], second[2] = (torch.roll(p, -(half % 128), dims=1)
                            for p in args[1:3])
    second[6], second[7] = (torch.roll(p, -(hd % 128), dims=1)
                            for p in args[6:8])
    second[5], second[9] = a[1], a[2]
    b = _mix_dec_mf_walk(*second, span=900)
    for p in ("re", "im"):
        assert torch.equal(torch.cat([getattr(a[0], p), getattr(b[0], p)], 1),
                           getattr(whole[0], p))
        assert torch.equal(getattr(b[1], p), getattr(whole[1], p))
        assert torch.equal(getattr(b[2], p), getattr(whole[2], p))


@pytest.mark.parametrize("m", [1, 3, 7, 10, 13, 20, 26, 27, 40])
def test_kernel_tap_offsets_address_the_layouts(m):
    """The offsets the CUDA kernel computes per tap name the words the
    layouts hold: FIR tap a of output i reads row (m-1-a) mod m, column
    i + h + floor((m-1-a)/m), which is sample j = (i+h+1)*m - 1 - a of the
    sub-chunk's polyphase input (j >= 0: no read before the halo); matched
    filter tap a of the thread whose outputs start at position
    p0 = 64 + 4t reads row (-a) mod 4, column p0/4 - ceil(a/4), which is
    bb position p0 - a."""
    h = 26 // m
    for sub in (32, 256):
        wp = (sub + h) | 1
        i = np.arange(sub)
        for a in range(27):
            e = m - 1 - a
            q = (e % m + m) % m
            got = q * wp + i + h + (e - q) // m
            j = (i + h + 1) * m - 1 - a
            assert (j >= 0).all() and (j < (h + sub) * m).all()
            assert np.array_equal(got, (j % m) * wp + j // m)
    c0 = 64 // 4 + np.arange(256)
    p0 = 64 + 4 * np.arange(256)
    for a in range(65):
        got = ((4 - a % 4) % 4) * 296 + c0 - (a + 3) // 4
        assert np.array_equal(got, ((p0 - a) % 4) * 296 + (p0 - a) // 4)
