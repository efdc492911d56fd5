"""Kernel 1's walk (``csrc/mix_decimate.cu`` on ``csrc/front_walk.cuh``),
rehearsed on the CPU through its plain mirror
``ops/mix_decimate.py::_mix_decimate_walk``: spans of a stream's outputs,
sub-chunks whose mixed input (with the FIR halo before it, the carried
tail where t < 0) sits in a polyphase layout at the words the kernel's
threads step to, ragged last sub-chunks and spans, and the new tail read
from the stream's last sub-chunk's buffer. It must equal
``mix_decimate_ref`` bit for bit on the decimated planes and the tail, at
every m the kernel takes a sub-chunk for, with the sub-chunk the kernel
takes there. The word offsets (stepped at run-time m, divided at a fixed
m) must name the samples the layout holds. chip_smoke.py phase 3 holds
the CUDA kernel against the plain version on the card."""

import numpy as np
import pytest
import torch

from jsdr_tpu_torch.demod.bpsk import DS_FILTER, HOWARD_FUDGE_FACTOR
from jsdr_tpu_torch.ops.cplx import CF
from jsdr_tpu_torch.ops.mix_decimate import (MAX_PER, THREADS,
                                             _mix_decimate_walk,
                                             _store_words, _tap_words,
                                             mix_decimate_ref, sub_chunk)

MS = [1, 3, 7, 10, 13, 14, 20, 26, 27, 40]


def _args(seed, s, t, m):
    rng = np.random.default_rng(seed)
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh)
                                     .astype(np.float32))
    ang = (np.arange(128) * 3 % 128) * (2 * np.pi / 128)
    cs = torch.from_numpy(np.tile(np.cos(ang).astype(np.float32), (s, 1)))
    sn = torch.from_numpy(np.tile(np.sin(ang).astype(np.float32), (s, 1)))
    return (CF(f(s, t), f(s, t)), cs, sn,
            torch.as_tensor(DS_FILTER, dtype=torch.float32), m,
            CF(f(s, 26), f(s, 26)), HOWARD_FUDGE_FACTOR)


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.re.shape == w.re.shape and g.im.shape == w.im.shape
        assert torch.equal(g.re, w.re) and torch.equal(g.im, w.im)


# outputs a block, and the span: one that divides neither the block nor a
# sub-chunk (ragged last span and sub-chunks), and one span for the block
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("n_out,span", [(1300, 333), (700, 700)])
def test_walk_equals_plain(m, n_out, span):
    args = _args(m * n_out + span, 2, n_out * m, m)
    got = _mix_decimate_walk(*args, span=span, sub=sub_chunk(m))
    _assert_equal(got, mix_decimate_ref(*args))


# a block shorter than one sub-chunk, one output, spans of 32 (the
# kernel's shortest), and kernel 1's ragged 13 x 95,440 shape (3 streams
# of it) at the span one wave gives there
@pytest.mark.parametrize("s,t,m,span", [
    (2, 1000, 10, 256), (2, 10, 10, 32), (2, 20, 20, 32), (2, 40, 40, 32),
    (2, 2000, 10, 32), (3, 95440, 10, 320)])
def test_walk_short_and_ragged_blocks(s, t, m, span):
    args = _args(s + t + m, s, t, m)
    got = _mix_decimate_walk(*args, span=span, sub=sub_chunk(m))
    _assert_equal(got, mix_decimate_ref(*args))


@pytest.mark.parametrize("m", [10, 14])
def test_walk_chained_half_blocks_equal_one_block(m):
    """Two chained half blocks (patterns rolled on by the first half's
    length, as the demodulator's state advances them) equal one whole
    block, bit for bit."""
    s, t = 2, 2560 * m
    args = list(_args(m, s, t, m))
    sub = sub_chunk(m)
    whole = _mix_decimate_walk(*args, span=900, sub=sub)
    half = t // 2
    x = args[0]
    first = list(args)
    first[0] = CF(x.re[:, :half].contiguous(), x.im[:, :half].contiguous())
    a = _mix_decimate_walk(*first, span=900, sub=sub)
    second = list(args)
    second[0] = CF(x.re[:, half:].contiguous(), x.im[:, half:].contiguous())
    second[1], second[2] = (torch.roll(p, -(half % 128), dims=1)
                            for p in args[1:3])
    second[5] = a[1]
    b = _mix_decimate_walk(*second, span=900, sub=sub)
    for p in ("re", "im"):
        assert torch.equal(torch.cat([getattr(a[0], p), getattr(b[0], p)], 1),
                           getattr(whole[0], p))
        assert torch.equal(getattr(b[1], p), getattr(whole[1], p))


@pytest.mark.parametrize("m", MS + [100, 672])
def test_kernel_words_address_the_layout(m):
    """The words the kernel computes name the samples the polyphase layout
    holds: a thread's stepped store words are (j % m) * wp + j // m for
    every staged j; FIR tap a of the output in column i reads, stepped or
    divided, the word of sample j = (i + h + 1) * m - 1 - a of the
    sub-chunk (j >= 0: no read before the halo; j < (h + sub) * m); and
    a thread stages at most MAX_PER samples a plane."""
    sub = sub_chunk(m)
    h = 26 // m
    wp = (sub + h) | 1
    assert 8 <= sub <= THREADS and (sub + h) * m <= MAX_PER * THREADS
    j = np.arange(MAX_PER * THREADS)
    assert np.array_equal(_store_words(m, wp), (j % m) * wp + j // m)
    fixed, stepped = _tap_words(m, wp, False), _tap_words(m, wp, True)
    assert np.array_equal(fixed, stepped)
    i = np.arange(sub)
    for a in range(27):
        j = (i + h + 1) * m - 1 - a
        assert (j >= 0).all() and (j < (h + sub) * m).all()
        assert np.array_equal(stepped[a] + i, (j % m) * wp + j // m)


def test_sub_chunk_rule():
    """256 outputs a sub-chunk up to m = 20, halved as m grows, none past
    m = 672 (the kernel refuses it)."""
    assert [sub_chunk(m) for m in (1, 10, 14, 20, 21, 40, 100, 672, 673)] \
        == [256, 256, 256, 256, 128, 128, 32, 8, 0]
