"""The port's batched telemetry chain (``bpsk_block_batch``, CPU: plain
PyTorch versions of its kernels) against the JAX package's: over three
chained blocks with per-stream tunings in pattern mode, and over two
chained blocks in every other mode (general, static, dofft, mixed:pattern,
mixed:general) at 96 and 192 kS/s, with and without ``fuse_mf``.

Decisions and everything derived from them must be equal: windows,
hit_corr, n_hits, bits, n_bits, counters, ring, tu_phase, vco_idx, the
peak schedule and the tuner's centre bins. The float state differs by
float32 rounding: the reference runs its FIRs as bf16x3/HIGHEST banded
matmuls and its EMA as triangular matmuls, the port as fp32 convolutions
and serial sums. So ds_tail (mixed samples; the quantized cos/sin may
differ by an ulp between libraries) is held to 1e-6 (an auto-tuned
stream's, which holds tuner feed samples, to the feed's 5e-6),
mf_tail/last_iq/e_ema to 1e-5, e_out (closed form vs serial) to 1e-4 and
the tuner's EMA peak power to 2e-5, each relative to the largest magnitude
of the compared array; the static mode's carried numerator (float32 host
ramp arithmetic) to 1e-6 relative."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsdr_tpu.demod import bpsk as JB
from jsdr_tpu.io.sources import synth_bpsk_stream
from jsdr_tpu.ops.cplx import CF as JCF
from jsdr_tpu_torch.demod import bpsk as TB
from jsdr_tpu_torch.ops.cplx import CF

CASES = [(96000, [12000.0, 9000.0, 21000.0]), (192000, [12000.0, 9000.0])]


def _streams(rate, tunings, n_blocks=3):
    """One AO-40 frame per stream at its own tuning (cut to the length of
    n_blocks), 2 s blocks."""
    t_len = 2 * rate
    iq = np.zeros((len(tunings), n_blocks * t_len), np.complex64)
    for s, tu in enumerate(tunings):
        pay = np.random.default_rng(100 + s).integers(0, 256, (1, 256),
                                                      dtype=np.uint8)
        sig = synth_bpsk_stream(pay, rate=rate, carrier_offset=tu,
                                preamble_bits=200, noise_rms=0.25, seed=s)
        n = min(len(sig), iq.shape[1])
        iq[s, :n] = sig[:n]
    return iq.reshape(len(tunings), n_blocks, t_len)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


def _assert_block_equal(out_t, st_t, out_j, st_j):
    for name in ("windows", "hit_corr", "n_hits", "bits", "n_bits"):
        np.testing.assert_array_equal(getattr(out_t, name).numpy(),
                                      np.asarray(getattr(out_j, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(out_t.energies[:, 1].numpy(),
                                  np.asarray(out_j.energies)[:, 1])
    for name in ("counters", "ring", "tu_phase", "vco_idx"):
        np.testing.assert_array_equal(getattr(st_t, name).numpy(),
                                      np.asarray(getattr(st_j, name)),
                                      err_msg=name)
    for name in ("peak", "new_peak", "pos"):
        np.testing.assert_array_equal(getattr(st_t.timing, name).numpy(),
                                      np.asarray(getattr(st_j.timing, name)))
    for p in ("re", "im"):
        _close(getattr(st_t.ds_tail, p), getattr(st_j.ds_tail, p), 1e-6)
        _close(getattr(st_t.mf_tail, p), getattr(st_j.mf_tail, p), 1e-5)
    _close(st_t.timing.e_ema, st_j.timing.e_ema, 1e-5)
    _close(st_t.timing.last_iq, st_j.timing.last_iq, 1e-5)
    _close(st_t.timing.e_out, st_j.timing.e_out, 1e-4)


def _jax_block(blk, cfg, st, tunings):
    out, st = JB.bpsk_block_batch(JCF(jnp.asarray(blk.real.copy()),
                                      jnp.asarray(blk.imag.copy())),
                                  cfg, st, tunings)
    return out, jax.tree.map(np.asarray, st)


def _port_block(blk, cfg, st, tunings, **kw):
    x = CF(torch.from_numpy(np.ascontiguousarray(blk.real)),
           torch.from_numpy(np.ascontiguousarray(blk.imag)))
    return TB.bpsk_block_batch(x, cfg, st, tunings, **kw)


@pytest.mark.parametrize("rate,tunings", CASES)
def test_block_batch_matches_jax_over_chained_blocks(rate, tunings):
    cfg = JB.BpskConfig(rate=rate, tuning=tunings[0])
    tcfg = TB.BpskConfig(rate=rate, tuning=tunings[0])
    blocks = _streams(rate, tunings)
    st_j = JB.bpsk_init_batch(cfg, len(tunings))
    st_t = TB.bpsk_init_batch(tcfg, len(tunings), "cpu")
    hits = 0
    for b in range(blocks.shape[1]):
        out_j, st_j = _jax_block(blocks[:, b], cfg, st_j, tunings)
        out_t, st_t = _port_block(blocks[:, b], tcfg, st_t, tunings)
        _assert_block_equal(out_t, st_t, out_j, st_j)
        hits += int(out_t.n_hits.sum())
    assert hits >= len(tunings)           # every stream's frame was found


@pytest.mark.parametrize("rate,tunings", CASES)
def test_state_carries_between_packages(rate, tunings):
    """JAX block 1 -> state_from_numpy -> port block 2 equals JAX block
    2; state_to_numpy gives back the reference's structure."""
    cfg = JB.BpskConfig(rate=rate, tuning=tunings[0])
    tcfg = TB.BpskConfig(rate=rate, tuning=tunings[0])
    blocks = _streams(rate, tunings, n_blocks=2)
    st0 = JB.bpsk_init_batch(cfg, len(tunings))
    _out1, st1 = _jax_block(blocks[:, 0], cfg, st0, tunings)
    out2_j, st2_j = _jax_block(blocks[:, 1], cfg, st1, tunings)
    out2_t, st2_t = _port_block(blocks[:, 1], tcfg,
                                TB.state_from_numpy(st1, "cpu"), tunings)
    _assert_block_equal(out2_t, st2_t, out2_j, st2_j)

    back = TB.state_to_numpy(TB.state_from_numpy(st1, "cpu"))
    rebuilt = jax.tree.unflatten(jax.tree.structure(st1),
                                 jax.tree.leaves(back))
    for a, b in zip(jax.tree.leaves(rebuilt), jax.tree.leaves(st1)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_what_still_raises():
    """Every tuning mode and compat_scan (tests/test_torch_compat_scan.py)
    run now; what raises is a block that is not whole bit periods, and an
    auto-tuned block that is not whole 0.1 s sub-blocks."""
    cfg = TB.BpskConfig(rate=96000)
    st = TB.bpsk_init_batch(cfg, 1, "cpu")
    x = CF(torch.zeros(1, 9680), torch.zeros(1, 9680))
    for tun in (12345.0, 12000.05):
        TB.bpsk_block_batch(x, cfg, st, [tun])
    with pytest.raises(ValueError, match="0.1 s sub-blocks"):
        TB.bpsk_block_batch(x, cfg._replace(dofft=True), st)
    with pytest.raises(ValueError, match="0.1 s sub-blocks"):
        TB.bpsk_block_batch(x, cfg, st, [12000.0], dofft=[True])
    out, _ = TB.bpsk_block_batch(x, cfg._replace(compat_scan=True), st)
    assert int(out.n_bits[0]) == 0
    with pytest.raises(ValueError, match="multiple of 8"):
        TB.bpsk_block_batch(CF(x.re[:, :9560], x.im[:, :9560]), cfg, st)


def test_nco_pattern_and_advance_match_reference():
    """Exact numerators (int64 here, int32 double-and-add there) for
    every pattern-mode tuning class, at both rates, from a mid-stream
    phase; cos/sin to one float32 ulp."""
    for rate in (96000, 192000):
        step = 750 if rate == 96000 else 1500
        tun = np.arange(0, 24001, step, dtype=np.float64)
        nu = JB.tunings_to_nu(tun)
        assert JB.pattern_mix_ok(tun, rate) and TB.pattern_mix_ok(tun, rate)
        nu0 = (np.arange(len(tun)) * 104729 % (10 * rate)).astype(np.float32)
        jc, js = JB._nco_pattern(jnp.asarray(nu0), jnp.asarray(nu), rate)
        tc, ts = TB._nco_pattern(torch.from_numpy(nu0),
                                 torch.from_numpy(nu).long(), rate)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1.2e-7)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1.2e-7)
        for n in (96000, 192000, 3 * 96000):
            ja = JB._nco_advance(jnp.asarray(nu0), jnp.asarray(nu), rate, n)
            ta = TB._nco_advance(torch.from_numpy(nu0),
                                 torch.from_numpy(nu).long(), rate, n)
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("rate,tunings", [(96000, [12000.0]),
                                          (96000, [12000.0, 9000.0])])
def test_fuse_mf_chain_matches_jax_pallas(rate, tunings):
    """``BpskConfig(fuse_mf=True)`` (kernel 6's plain version on the CPU)
    against JAX's fused chain, ``bpsk_block_batch(use_pallas=True)`` with
    its kernels in interpret mode, on the reference's test signal
    (tests/test_bpsk_chain.py:290-315): the same hits, hit_corr and
    decoded payloads in every block. The reference's kernel reassociates
    the FIR sums (bf16x3 banded matmuls), so only decisions are held
    equal, as its own test does."""
    from jsdr_tpu.fec.decoder import fec_decode as j_fec
    from jsdr_tpu_torch.fec.decoder import fec_decode as t_fec

    rng = np.random.default_rng(1234)
    payloads = rng.integers(0, 256, (len(tunings), 256), dtype=np.uint8)
    sigs = [synth_bpsk_stream(payloads[i:i + 1], rate=rate,
                              carrier_offset=tu, preamble_bits=200)
            for i, tu in enumerate(tunings)]
    n = max(map(len, sigs))
    n += (-n) % rate
    iq = np.zeros((len(tunings), n), np.complex64)
    for i, sig in enumerate(sigs):
        iq[i, :len(sig)] = sig
    cfg = JB.BpskConfig(rate=rate, tuning=tunings[0], fuse_mf=True)
    tcfg = TB.BpskConfig(rate=rate, tuning=tunings[0], fuse_mf=True)
    st_j = JB.bpsk_init_batch(cfg, len(tunings))
    st_t = TB.bpsk_init_batch(tcfg, len(tunings), "cpu")
    decoded = []
    for b in range(n // rate):
        blk = iq[:, b * rate:(b + 1) * rate]
        out_j, st_j = JB.bpsk_block_batch(
            JCF(jnp.asarray(blk.real.copy()), jnp.asarray(blk.imag.copy())),
            cfg, st_j, tunings, use_pallas=True)
        out_t, st_t = _port_block(blk, tcfg, st_t, tunings)
        for name in ("n_hits", "hit_corr"):
            np.testing.assert_array_equal(getattr(out_t, name).numpy(),
                                          np.asarray(getattr(out_j, name)))
        np.testing.assert_array_equal(st_t.vco_idx.numpy(),
                                      np.asarray(st_j.vco_idx))
        for s in range(len(tunings)):
            nh = int(out_t.n_hits[s])
            if nh:
                rt, rj = t_fec(out_t.windows[s, :nh]), j_fec(
                    out_j.windows[s, :nh])
                np.testing.assert_array_equal(rt.ok.numpy(),
                                              np.asarray(rj.ok))
                np.testing.assert_array_equal(rt.payload.numpy(),
                                              np.asarray(rj.payload))
                decoded += [(s, p) for p, ok in zip(rt.payload.numpy(),
                                                    rt.ok.numpy()) if ok]
    assert [s for s, _ in decoded] == list(range(len(tunings)))
    for s, p in decoded:
        np.testing.assert_array_equal(p, payloads[s])


class _Mode(Exception):
    pass


@pytest.mark.parametrize("rate,tunings,dofft,want", [
    (96000, [12000.0, 9000.0], None, "pattern"),
    (96000, [1200.0], None, "general"),
    (96000, [12000.5, 12000.0], None, "general"),
    (96000, [12000.05], None, "static"),
    (96000, [12000.0, 0.0], [True, True], "dofft"),
    (96000, [12000.0, 0.0], [False, True], "mixed:pattern"),
    (96000, [12345.0, 0.0], [False, True], "mixed:general"),
    (96000, [12000.05, 0.0], [True, False], "mixed:static"),
    (192000, [1500.0, 750.0], None, "general"),
    (192000, [13500.0], None, "pattern"),
])
def test_mix_mode_matches_jax(monkeypatch, rate, tunings, dofft, want):
    """Which front end each tuning set takes, as the reference picks it
    (its batch entry point's mix_mode): pattern for 128-periodic NCO
    sequences, general for other 0.1 Hz multiples, static below 0.1 Hz,
    then dofft / mixed:<mode> from the per-stream flags."""
    flags = np.zeros(len(tunings), bool) if dofft is None else dofft

    def capture(*a, **k):
        raise _Mode(k["mix_mode"])

    monkeypatch.setattr(JB, "_bpsk_block_batched", capture)
    iq = JCF(jnp.zeros((len(tunings), 96)), jnp.zeros((len(tunings), 96)))
    with (pytest.warns(RuntimeWarning) if want.endswith("static")
          else contextlib.nullcontext()):
        with pytest.raises(_Mode) as got:
            JB.bpsk_block_batch(iq, JB.BpskConfig(rate=rate), None,
                                np.asarray(tunings), dofft=flags)
    assert got.value.args[0] == want
    assert TB.mix_mode_for(np.asarray(tunings), rate, flags) == want


def _mode_streams(rate, carriers, n_blocks, block_s=2.4):
    """One noisy AO-40 frame per stream at ``carriers`` (400-bit preamble,
    noise rms 0.25), in n_blocks chained blocks of block_s seconds."""
    t_len = int(block_s * rate)
    iq = np.zeros((len(carriers), n_blocks * t_len), np.complex64)
    pays = []
    for s, c in enumerate(carriers):
        pay = np.random.default_rng(200 + s).integers(0, 256, (1, 256),
                                                      dtype=np.uint8)
        sig = synth_bpsk_stream(pay, rate=rate, carrier_offset=c,
                                preamble_bits=400, noise_rms=0.25, seed=s)
        n = min(len(sig), iq.shape[1])
        iq[s, :n] = sig[:n]
        pays.append(pay[0])
    return iq.reshape(len(carriers), n_blocks, t_len), np.stack(pays)


# (rate, tunings, carriers, dofft, track_high): every mode at both rates;
# a dofft stream with track_high searches the upper half-band
MODE_CASES = [
    (96000, [1200.0, 12345.0], [1200.0, 12345.0], None, None),
    (192000, [1200.0, 7123.4], [1200.0, 7123.4], None, None),
    (96000, [12000.05, 6000.07], [12000.05, 6000.07], None, None),
    (192000, [9000.05], [9000.05], None, None),
    (96000, [0.0, 0.0], [11900.0, 30000.0], [True, True], [False, True]),
    (192000, [0.0, 0.0], [11900.0, 60000.0], [True, True], [False, True]),
    (96000, [12000.0, 0.0], [12000.0, 9300.0], [False, True], None),
    (96000, [12345.0, 0.0], [12345.0, 30000.0], [False, True],
     [False, True]),
    (192000, [7123.4, 0.0], [7123.4, 11900.0], [False, True], None),
]


@pytest.mark.parametrize("rate,tunings,carriers,dofft,track_high",
                         MODE_CASES)
def test_every_mode_matches_jax_over_chained_blocks(rate, tunings, carriers,
                                                    dofft, track_high):
    """The general, static, dofft, mixed:pattern and mixed:general modes
    over two chained blocks: every decision, counter, ring, vco_idx, the
    tuner's centre bins and tu_phase equal to the reference's (the static
    numerator to 1e-6 relative), float state within this file's
    tolerances (ds_tail of an auto-tuned stream, which holds tuner feed
    samples, within the feed's 5e-6), and every frame decoded. With
    ``fuse_mf`` set, the general and static modes run the unfused chain,
    bit for bit, as the reference's rule says."""
    from jsdr_tpu_torch.fec.decoder import fec_decode as t_fec

    blocks, pays = _mode_streams(rate, carriers, 2)
    kw = dict(dofft=dofft, track_high=track_high)
    cfg = JB.BpskConfig(rate=rate, tuning=tunings[0])
    tcfg = TB.BpskConfig(rate=rate, tuning=tunings[0])
    mode = TB.mix_mode_for(np.asarray(tunings), rate,
                           np.zeros(len(tunings), bool) if dofft is None
                           else dofft)
    st_j = JB.bpsk_init_batch(cfg, len(tunings))
    st_t = TB.bpsk_init_batch(tcfg, len(tunings), "cpu")
    st_f = st_t
    auto = np.zeros(len(tunings), bool) if dofft is None else np.array(dofft)
    good = np.zeros(len(tunings), int)
    for b in range(blocks.shape[1]):
        blk = blocks[:, b]
        out_j, st_j = JB.bpsk_block_batch(
            JCF(jnp.asarray(blk.real.copy()), jnp.asarray(blk.imag.copy())),
            cfg, st_j, tunings, **kw)
        st_j = jax.tree.map(np.asarray, st_j)
        out_t, st_t = _port_block(blk, tcfg, st_t, tunings, **kw)
        for name in ("windows", "hit_corr", "n_hits", "bits", "n_bits"):
            np.testing.assert_array_equal(getattr(out_t, name).numpy(),
                                          np.asarray(getattr(out_j, name)),
                                          err_msg=name)
        for name in ("counters", "ring", "vco_idx"):
            np.testing.assert_array_equal(getattr(st_t, name).numpy(),
                                          getattr(st_j, name), err_msg=name)
        for name in ("peak", "new_peak", "pos"):
            np.testing.assert_array_equal(getattr(st_t.timing, name).numpy(),
                                          getattr(st_j.timing, name))
        for name in ("centre_bin", "ave_centre_bin"):
            np.testing.assert_array_equal(
                getattr(st_t.fft_tuner, name).numpy(),
                getattr(st_j.fft_tuner, name))
        _close(st_t.fft_tuner.ave_peak_power, st_j.fft_tuner.ave_peak_power,
               2e-5)
        if mode.endswith("static"):
            np.testing.assert_allclose(st_t.tu_phase.numpy(), st_j.tu_phase,
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(st_t.tu_phase.numpy(),
                                          st_j.tu_phase)
        for p in ("re", "im"):
            for s in range(len(tunings)):
                _close(getattr(st_t.ds_tail, p)[s],
                       getattr(st_j.ds_tail, p)[s], 5e-6 if auto[s] else 1e-6)
            _close(getattr(st_t.mf_tail, p), getattr(st_j.mf_tail, p), 1e-5)
        _close(st_t.timing.e_ema, st_j.timing.e_ema, 1e-5)
        _close(st_t.timing.last_iq, st_j.timing.last_iq, 1e-5)
        _close(st_t.timing.e_out, st_j.timing.e_out, 1e-4)
        if mode in ("general", "static"):
            # fuse_mf set: the reference's rule keeps the unfused chain
            out_f, st_f = _port_block(blk, tcfg._replace(fuse_mf=True),
                                      st_f, tunings, **kw)
            for a, c in zip(out_f, out_t):
                assert torch.equal(a, c)
        for s in range(len(tunings)):
            nh = int(out_t.n_hits[s])
            if nh:
                res = t_fec(out_t.windows[s, :nh])
                good[s] += sum(bool(res.ok[i]) and np.array_equal(
                    res.payload[i].numpy(), pays[s]) for i in range(nh))
    assert good.tolist() == [1] * len(tunings)


@pytest.mark.parametrize("tunings,carriers,dofft", [
    ([0.0], [11900.0], [True]),
    ([12000.0, 0.0], [12000.0, 9300.0], [False, True]),
])
def test_dofft_fuse_mf_matches_jax_pallas(tunings, carriers, dofft):
    """dofft and mixed:pattern under ``fuse_mf`` (kernel 6's plain version
    on the CPU) against the reference's fused chain, as
    test_fuse_mf_chain_matches_jax_pallas runs it (``use_pallas=True``,
    kernels interpreted), over two chained blocks: the same hits,
    hit_corr, vco_idx, centre bins and decoded payloads."""
    from jsdr_tpu_torch.fec.decoder import fec_decode as t_fec

    rate = 96000
    blocks, pays = _mode_streams(rate, carriers, 2)
    cfg = JB.BpskConfig(rate=rate, fuse_mf=True)
    tcfg = TB.BpskConfig(rate=rate, fuse_mf=True)
    st_j = JB.bpsk_init_batch(cfg, len(tunings))
    st_t = TB.bpsk_init_batch(tcfg, len(tunings), "cpu")
    good = np.zeros(len(tunings), int)
    for b in range(blocks.shape[1]):
        blk = blocks[:, b]
        out_j, st_j = JB.bpsk_block_batch(
            JCF(jnp.asarray(blk.real.copy()), jnp.asarray(blk.imag.copy())),
            cfg, st_j, tunings, use_pallas=True, dofft=dofft)
        out_t, st_t = _port_block(blk, tcfg, st_t, tunings, dofft=dofft)
        for name in ("n_hits", "hit_corr"):
            np.testing.assert_array_equal(getattr(out_t, name).numpy(),
                                          np.asarray(getattr(out_j, name)))
        np.testing.assert_array_equal(st_t.vco_idx.numpy(),
                                      np.asarray(st_j.vco_idx))
        np.testing.assert_array_equal(st_t.fft_tuner.centre_bin.numpy(),
                                      np.asarray(st_j.fft_tuner.centre_bin))
        for s in range(len(tunings)):
            nh = int(out_t.n_hits[s])
            if nh:
                res = t_fec(out_t.windows[s, :nh])
                good[s] += sum(bool(res.ok[i]) and np.array_equal(
                    res.payload[i].numpy(), pays[s]) for i in range(nh))
    assert good.tolist() == [1] * len(tunings)


def _decode_port(sig, rate, tuning, block):
    """One stream through the port's chain (CPU) in ``block``-sample
    blocks; returns the FEC-decoded good payloads."""
    from jsdr_tpu_torch.fec.decoder import fec_decode as t_fec

    sig = np.concatenate([sig, np.zeros((-len(sig)) % block, np.complex64)])
    cfg = TB.BpskConfig(rate=rate, tuning=tuning)
    st = TB.bpsk_init_batch(cfg, 1, "cpu")
    good = []
    for b in range(len(sig) // block):
        out, st = _port_block(sig[None, b * block:(b + 1) * block], cfg, st,
                              None)
        nh = int(out.n_hits[0])
        if nh:
            res = t_fec(out.windows[0, :nh])
            good += [res.payload[i].numpy() for i in range(nh)
                     if bool(res.ok[i])]
    return good


@pytest.mark.parametrize("tuning,want_mode", [(12000.5, "general"),
                                              (1200.0, "general"),
                                              (12000.05, "static")])
def test_off_grid_tunings_decode(tuning, want_mode):
    """tests/test_bpsk_chain.py:65 (a 0.1 Hz-multiple tuning, 12000.5 Hz)
    and :165 (1200 Hz, not 128-periodic at 96 kS/s) on the port, and a
    sub-0.1 Hz one: each takes its mode and decodes its frame
    bit-exact."""
    payload = np.random.default_rng(1234).integers(0, 256, (1, 256),
                                                   dtype=np.uint8)
    sig = synth_bpsk_stream(payload, rate=96000, carrier_offset=tuning,
                            preamble_bits=200)
    assert TB.mix_mode_for([tuning], 96000, [False]) == want_mode
    good = _decode_port(sig, 96000, tuning, 96000)
    assert len(good) == 1 and np.array_equal(good[0], payload[0])
