"""The port's FFT auto-tuner (``jsdr_tpu_torch/demod/fft_tuner.py``) and its
dofft front end against the JAX package's, on the CPU.

Tolerances (relative to the largest magnitude of the compared array):

- the spectrum, torch.fft against the reference's matmul FFT: 2e-6;
- the box-summed PSD and its block maxima: 2e-5 (they sum 100 bins of it;
  the port keeps the reference's order of additions, so only the
  spectrum's rounding moves them);
- the tuner's feed (the slice's inverse transform, one float32 matmul in
  both): 5e-6;
- the EMA peak power through a whole chain: 2e-5.

Peak bins, the half-band end, centre bins, ``ave_centre_bin`` and every
decision downstream are held equal; the recurrence alone, given the same
inputs, is held bit for bit (state and centres).

The signals carry noise (rms 0.25). On a noise-free synthetic frame whose
carrier sits on a 10 Hz bin the spectrum is mirror-symmetric about the
carrier, so the box sum's top is an exact tie between two bins in exact
arithmetic, and each library's float32 rounding breaks it its own way:
there the tuner's centre may differ by a few bins between packages (and
between the CPU and the card) while both still decode. The reference
tests' own noise-free signals (tests/test_demod.py:76-135,
tests/test_bpsk_chain.py:232) are run through the port alone, with their
own assertions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from jsdr_tpu.demod import bpsk as JB
from jsdr_tpu.demod import fft_tuner as JT
from jsdr_tpu.io.sources import synth_bpsk_stream, synth_sine
from jsdr_tpu.ops.cplx import CF as JCF
from jsdr_tpu_torch.demod import bpsk as TB
from jsdr_tpu_torch.demod import fft_tuner as TT
from jsdr_tpu_torch.fec.decoder import fec_decode as t_fec
from jsdr_tpu_torch.ops.cplx import CF


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _blocks(rate, n_blocks, carriers, seed=0):
    """[S, n_blocks, rate/10] sub-blocks of noisy frames at ``carriers``
    (the first block starts 1.2 s into each frame)."""
    samples = rate // 10
    out = []
    for s, c in enumerate(carriers):
        pay = np.random.default_rng(seed + s).integers(0, 256, (1, 256),
                                                       dtype=np.uint8)
        sig = synth_bpsk_stream(pay, rate=rate, carrier_offset=c,
                                preamble_bits=400, noise_rms=0.25, seed=s)
        start = int(1.2 * rate)
        out.append(sig[start:start + n_blocks * samples])
    return np.stack(out).reshape(len(carriers), n_blocks, samples)


def _jcf(x):
    return JCF(jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy()))


def _tcf(x):
    return CF(_t(x.real.astype(np.float32)), _t(x.imag.astype(np.float32)))


# a lower half-band carrier, and one in the upper half-band (track_high)
CASES = [(96000, [11900.0, 30000.0]), (192000, [11900.0, 60000.0])]


@pytest.mark.parametrize("rate,carriers", CASES)
def test_precompute_recurrence_and_emit_match_jax(rate, carriers):
    x = _blocks(rate, 6, carriers)
    th = np.array([False, True])
    pre_t = TT.tuner_precompute(_tcf(x), _t(th))
    st = [np.float32(1234.5), np.float32(1320.0), np.int32(1321)]
    for s in range(len(carriers)):
        spec, ave, bin_pos, max_bin, end = JT.tuner_precompute(_jcf(x[s]),
                                                               th[s])
        _close(pre_t[0].re[s], spec.re, 2e-6)
        _close(pre_t[0].im[s], spec.im, 2e-6)
        _close(pre_t[1][s], ave, 2e-5)
        np.testing.assert_array_equal(pre_t[2][s].numpy(),
                                      np.asarray(bin_pos))
        _close(pre_t[3][s], max_bin, 2e-5)
        assert int(pre_t[4][s]) == int(end)

        # the recurrence on the reference's own inputs, from a mid-stream
        # state: bit for bit
        j0 = JT.FftTunerState(*map(np.asarray, st))
        j_state, j_centres = JT.tuner_recurrence(j0, ave, bin_pos, max_bin,
                                                 end)
        t0 = TT.FftTunerState(*(torch.tensor(v)[None] for v in st))
        t_state, t_centres = TT.tuner_recurrence(
            t0, _t(np.asarray(ave))[None], _t(np.asarray(bin_pos))[None],
            _t(np.asarray(max_bin))[None], torch.tensor([int(end)]))
        np.testing.assert_array_equal(t_centres[0].numpy(),
                                      np.asarray(j_centres))
        for a, b in zip(t_state, j_state):
            assert a.dtype == torch.from_numpy(np.asarray(b)).dtype
            np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))

        # the feed from the reference's spectrum and centres
        feed_j = JT.tuner_emit(spec, j_centres)
        feed_t = TT.tuner_emit(CF(_t(np.asarray(spec.re))[None],
                                  _t(np.asarray(spec.im))[None]),
                               t_centres)
        _close(feed_t.re[0], feed_j.re, 5e-6)
        assert feed_t.re is feed_t.im              # the Q-drop quirk


@pytest.mark.parametrize("rate,carriers", CASES)
def test_fft_tuner_blocks_match_jax(rate, carriers):
    """The whole tuner, per-stream track_high, over two calls (the state
    carried): the same centres and centre state; the feed and peak power
    within their tolerances."""
    x = _blocks(rate, 8, carriers, seed=5)
    th = np.array([False, True])
    st_t = TT.fft_tuner_init(len(carriers), "cpu")
    st_j = [JT.fft_tuner_init() for _ in carriers]
    for half in (x[:, :4], x[:, 4:]):
        feed_t, cen_t, st_t = TT.fft_tuner_blocks(_tcf(half), st_t, _t(th))
        for s in range(len(carriers)):
            feed_j, cen_j, st_j[s] = JT.fft_tuner_blocks(_jcf(half[s]),
                                                         st_j[s], th[s])
            np.testing.assert_array_equal(cen_t[s].numpy(),
                                          np.asarray(cen_j))
            _close(feed_t.re[s], feed_j.re, 5e-6)
            assert int(st_t.centre_bin[s]) == int(st_j[s].centre_bin)
            assert (float(st_t.ave_centre_bin[s])
                    == float(st_j[s].ave_centre_bin))
            np.testing.assert_allclose(float(st_t.ave_peak_power[s]),
                                       float(st_j[s].ave_peak_power),
                                       rtol=2e-5)
    # each carrier's (offset + 1200 Hz) tone was found, in its half-band
    np.testing.assert_allclose(st_t.centre_bin.numpy(),
                               (np.asarray(carriers) + 1200) / 10, atol=15)


def test_fft_tuner_tracks_peak():
    """tests/test_demod.py:76 on the port: a pure tone's 100-bin box sum
    is a flat plateau, and the first-max rule (mirroring Java's strict >)
    picks its left edge: binPos = 1310 - 49, centreBin = binPos + 1."""
    rate = 96000
    samples = rate // 10
    iq = synth_sine(samples * 10, 13100.0, rate, amplitude=0.6)
    feed, centres, st = TT.fft_tuner_blocks(
        _tcf(iq.reshape(1, 10, samples)), TT.fft_tuner_init(1, "cpu"),
        torch.tensor([False]))
    assert int(centres[0, -1]) == 1262
    assert torch.equal(feed.re, feed.im)                 # Q-drop
    _jf, j_centres, _js = JT.fft_tuner_blocks(
        _jcf(iq.reshape(10, samples)), JT.fft_tuner_init())
    np.testing.assert_array_equal(centres[0].numpy(), np.asarray(j_centres))


def _decode_dofft_port(sig, rate, payload, **kw):
    """The port's dofft chain over 1 s blocks of one stream; returns the
    good frame count and the final state."""
    sig = np.concatenate([sig, np.zeros((-len(sig)) % rate, np.complex64)])
    cfg = TB.BpskConfig(rate=rate, dofft=True, **kw)
    st = TB.bpsk_init_batch(cfg, 1, "cpu")
    good = 0
    for b in range(len(sig) // rate):
        out, st = TB.bpsk_block_batch(_tcf(sig[None, b * rate:(b + 1) * rate]),
                                      cfg, st)
        nh = int(out.n_hits[0])
        if nh:
            res = t_fec(out.windows[0, :nh])
            good += sum(bool(res.ok[i]) and np.array_equal(
                res.payload[i].numpy(), payload) for i in range(nh))
    return good, st


@pytest.mark.parametrize("rate,seed", [(96000, 2), (192000, 3)])
@pytest.mark.parametrize("fuse_mf", [False, True])
def test_fft_tune_full_chain_decodes(rate, seed, fuse_mf):
    """tests/test_demod.py:89 (96 kS/s) and :112 (192 kS/s) on the port,
    with and without the fused matched filter: the frame decodes
    bit-exact and the tuner locks near the carrier."""
    rng = np.random.default_rng(1234)
    payloads = rng.integers(0, 256, (1, 256), dtype=np.uint8)
    sig = synth_bpsk_stream(payloads, rate=rate, carrier_offset=11900.0,
                            preamble_bits=400, seed=seed)
    good, st = _decode_dofft_port(sig, rate, payloads[0], fuse_mf=fuse_mf)
    assert good == 1
    assert int(st.fft_tuner.centre_bin[0]) == pytest.approx(1310, abs=15)


def test_mixed_dofft_batch_one_call():
    """tests/test_bpsk_chain.py:232 on the port: stream 0 manually tuned at
    12 kHz, stream 1 auto-tuned to an 11.9 kHz carrier, in one call; the
    manual stream's tuner state never advances."""
    rng = np.random.default_rng(1234)
    pay_b = rng.integers(0, 256, (1, 256), dtype=np.uint8)
    pay_a = rng.integers(0, 256, (1, 256), dtype=np.uint8)
    payloads = np.concatenate([pay_a, pay_b])
    sig_a = synth_bpsk_stream(payloads[:1], rate=96000,
                              carrier_offset=12000.0, preamble_bits=400)
    sig_b = synth_bpsk_stream(payloads[1:], rate=96000,
                              carrier_offset=11900.0, preamble_bits=400,
                              seed=2)
    n = max(len(sig_a), len(sig_b))
    n += (-n) % 96000
    iq = np.zeros((2, n), np.complex64)
    iq[0, :len(sig_a)] = sig_a
    iq[1, :len(sig_b)] = sig_b
    cfg = TB.BpskConfig(rate=96000)
    states = TB.bpsk_init_batch(cfg, 2, "cpu")
    good = [0, 0]
    for b in range(n // 96000):
        out, states = TB.bpsk_block_batch(
            _tcf(iq[:, b * 96000:(b + 1) * 96000]), cfg, states,
            np.asarray([12000, 0]), dofft=[False, True])
        for s in range(2):
            nh = int(out.n_hits[s])
            if nh:
                res = t_fec(out.windows[s, :nh])
                good[s] += sum(bool(res.ok[i]) and np.array_equal(
                    res.payload[i].numpy(), payloads[s]) for i in range(nh))
    assert good == [1, 1]
    assert int(states.fft_tuner.centre_bin[1]) == pytest.approx(1310, abs=15)
    assert int(states.fft_tuner.centre_bin[0]) == 0
    assert float(states.tu_phase[1]) == 0.0


def test_chip_smoke_dofft_streams_decode_in_both_packages():
    """chip_smoke.py's phase-12 dofft set: the JAX package's windows decode
    to every stream's payload bit-exact, and the port's chain (CPU) gives
    the same decisions, centre bins and payloads in every 1 s block."""
    rate = 96000
    iq, payloads = chip_smoke.dofft_signals(rate)
    s = len(payloads)
    cfg_j = JB.BpskConfig(rate=rate, dofft=True)
    cfg_t = TB.BpskConfig(rate=rate, dofft=True)
    st_j = JB.bpsk_init_batch(cfg_j, s)
    st_t = TB.bpsk_init_batch(cfg_t, s, "cpu")
    hits_j, hits_t = [], []          # (stream, window) of every sync hit
    for b in range(iq.shape[1] // rate):
        blk = iq[:, b * rate:(b + 1) * rate]
        out_j, st_j = JB.bpsk_block_batch(_jcf(blk), cfg_j, st_j)
        out_t, st_t = TB.bpsk_block_batch(_tcf(blk), cfg_t, st_t)
        for name in ("n_hits", "hit_corr", "bits", "n_bits"):
            np.testing.assert_array_equal(getattr(out_t, name).numpy(),
                                          np.asarray(getattr(out_j, name)))
        np.testing.assert_array_equal(st_t.fft_tuner.centre_bin.numpy(),
                                      np.asarray(st_j.fft_tuner.centre_bin))
        for i in range(s):
            for k in range(int(out_j.n_hits[i])):
                hits_j.append((i, np.asarray(out_j.windows[i, k])))
                hits_t.append((i, out_t.windows[i, k]))
    # every hit of the run in one batched decode a package's windows (the
    # port's fec_decode, held bit-exact to the reference's in
    # tests/test_torch_fec.py: its compile costs far less on the CPU)
    for hits in (hits_j, hits_t):
        res = t_fec(torch.stack([torch.as_tensor(w) for _, w in hits]))
        good = [sum(bool(res.ok[k]) and np.array_equal(
            res.payload[k].numpy(), payloads[i])
            for k, (j, _) in enumerate(hits) if j == i) for i in range(s)]
        assert good == [1] * s
    carriers = np.array([c for c, _ in chip_smoke.DOFFT_STREAMS])
    np.testing.assert_allclose(st_t.fft_tuner.centre_bin.numpy(),
                               (carriers + 1200) / 10, atol=15)
