"""The flagship step of the port, ``bpsk_block_batch_spectrum`` (CPU: the
plain versions of its kernels), against the JAX package's, and its
merged branch against its staged one.

Set-up of tests/test_bpsk_chain.py's merged-step test: one AO-40 frame at
96 kS/s (4.5 s with its preamble) on stream 0 and the same samples
reversed on stream 1, in chained 2 s blocks (3 blocks hold the frame).
Both packages start from one numpy state. The reference runs with
``use_pallas=False`` (its spectrum kernel interpreted at the default
bf16x3 precision). Decisions, counters, ring and payloads must be equal;
waterfall lines within 0.2 dB (bf16x3 against fp32), peaks within 1e-3 dB
with equal frequencies; float state within tests/test_torch_bpsk.py's
tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jsdr_tpu.ops.pallas_kernels as jpk
from jsdr_tpu.demod import bpsk as JB
from jsdr_tpu.io.sources import synth_bpsk_stream
from jsdr_tpu.ops.cplx import CF as JCF
from jsdr_tpu_torch.demod import bpsk as TB
from jsdr_tpu_torch.fec.decoder import fec_decode
from jsdr_tpu_torch.ops.cplx import CF
from jsdr_tpu_torch.ops.spectrum_fused import spectrum_waterfall


def _frame(rate, block, carrier=12000.0):
    payload = np.random.default_rng(1234).integers(0, 256, (1, 256),
                                                   dtype=np.uint8)
    sig = synth_bpsk_stream(payload, rate=rate, carrier_offset=carrier,
                            preamble_bits=200, noise_rms=0.2)
    n = len(sig) + (-len(sig)) % block
    iq = np.zeros((2, n), np.complex64)
    iq[0, :len(sig)] = sig
    iq[1, :len(sig)] = sig[::-1]
    return payload[0], iq


def _cf(blk):
    return CF(torch.from_numpy(np.ascontiguousarray(blk.real)),
              torch.from_numpy(np.ascontiguousarray(blk.imag)))


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


def _assert_step_equal(out_t, st_t, out_j, st_j, ds_rel=1e-6):
    for name in ("windows", "hit_corr", "n_hits", "bits", "n_bits"):
        np.testing.assert_array_equal(getattr(out_t, name).numpy(),
                                      np.asarray(getattr(out_j, name)),
                                      err_msg=name)
    st_t = TB.state_to_numpy(st_t)
    for name in ("counters", "ring", "tu_phase", "vco_idx"):
        np.testing.assert_array_equal(getattr(st_t, name),
                                      np.asarray(getattr(st_j, name)),
                                      err_msg=name)
    for name in ("peak", "new_peak", "pos"):
        np.testing.assert_array_equal(getattr(st_t.timing, name),
                                      np.asarray(getattr(st_j.timing, name)))
    for p in ("re", "im"):
        _close(getattr(st_t.ds_tail, p), getattr(st_j.ds_tail, p), ds_rel)
        _close(getattr(st_t.mf_tail, p), getattr(st_j.mf_tail, p), 1e-5)
    _close(st_t.timing.e_ema, st_j.timing.e_ema, 1e-5)
    _close(st_t.timing.last_iq, st_j.timing.last_iq, 1e-5)
    _close(st_t.timing.e_out, st_j.timing.e_out, 1e-4)


@pytest.mark.parametrize("block", [192000, 96000])
def test_spectrum_step_matches_jax(block):
    """2 s blocks take the merged kernel, 1 s blocks the staged pair, in
    both packages."""
    rate = 96000
    payload, iq = _frame(rate, block)
    cfg = JB.BpskConfig(rate=rate, tuning=12000.0)
    tcfg = TB.BpskConfig(rate=rate, tuning=12000.0)
    assert TB.spectrum_step_merged(tcfg, block, [12000.0] * 2) == (
        block == 192000)
    st_j = jax.tree.map(np.asarray, JB.bpsk_init_batch(cfg, 2))
    st_t = TB.state_from_numpy(st_j, "cpu")
    payloads = []
    for b in range(iq.shape[1] // block):
        blk = iq[:, b * block:(b + 1) * block]
        spec_j, out_j, st_j = JB.bpsk_block_batch_spectrum(
            blk, cfg, st_j, use_pallas=False)
        st_j = jax.tree.map(np.asarray, st_j)
        spec_t, out_t, st_t = TB.bpsk_block_batch_spectrum(_cf(blk), tcfg,
                                                           st_t)
        assert tuple(spec_t.wf.shape) == (block // 9600, 2, 15, 128)
        np.testing.assert_allclose(spec_t.wf.numpy(), np.asarray(spec_j.wf),
                                   rtol=0, atol=0.2)
        np.testing.assert_allclose(spec_t.peak_db.numpy(),
                                   np.asarray(spec_j.peak_db), atol=1e-3)
        np.testing.assert_array_equal(spec_t.peak_freq.numpy(),
                                      np.asarray(spec_j.peak_freq))
        _assert_step_equal(out_t, st_t, out_j, st_j)
        for s in range(2):
            nh = int(out_t.n_hits[s])
            if nh:
                res = fec_decode(out_t.windows[s, :nh])
                payloads += [(s, bytes(p)) for ok, p in
                             zip(res.ok.numpy(), res.payload.numpy()) if ok]
    assert payloads == [(0, payload.tobytes())]


@pytest.mark.parametrize("rate", [96000, 192000])
def test_merged_step_equals_staged_pair(rate):
    """On eligible blocks (2 s: T % (blocks * n) == 0 at both rates) the
    merged step equals spectrum_waterfall + bpsk_block_batch run by hand,
    bit for bit."""
    block = 2 * rate
    _payload, iq = _frame(rate, block)
    tun = np.array([12000.0, 12000.0])
    cfg = TB.BpskConfig(rate=rate, tuning=12000.0)
    assert TB.spectrum_step_merged(cfg, block, tun)
    st_m = st_s = TB.bpsk_init_batch(cfg, 2, "cpu")
    for b in range(2):
        x = _cf(iq[:, b * block:(b + 1) * block])
        spec, out_m, st_m = TB.bpsk_block_batch_spectrum(x, cfg, st_m)
        wf, mx, idx = spectrum_waterfall(x, rate // 10)
        out_s, st_s = TB.bpsk_block_batch(x, cfg, st_s, tun)
        want = TB._waterfall_out(wf, mx, idx, rate)
        for name in ("wf", "peak_db", "peak_freq"):
            assert torch.equal(getattr(spec, name), getattr(want, name)), name
        for a, b_ in zip(out_m, out_s):
            assert torch.equal(a, b_)
        for a, b_ in zip(TB.state_to_numpy(st_m), TB.state_to_numpy(st_s)):
            for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b_)):
                np.testing.assert_array_equal(u, v)


class _Merged(Exception):
    pass


class _Staged(Exception):
    pass


def _jax_branch(monkeypatch, cfg, t_len, tunings):
    def merged(*a, **k):
        raise _Merged

    def staged(*a, **k):
        raise _Staged

    monkeypatch.setattr(JB, "_bpsk_spectrum_batched", merged)
    monkeypatch.setattr(jpk, "spectrum_waterfall", staged)
    iq = JCF(jnp.zeros((len(tunings), t_len)), jnp.zeros((len(tunings), t_len)))
    try:
        JB.bpsk_block_batch_spectrum(iq, cfg, None, tunings)
    except _Merged:
        return True
    except _Staged:
        return False
    raise AssertionError("the reference took neither branch")


@pytest.mark.parametrize("rate,t_len,tunings,flags", [
    (96000, 38400, [12000.0], {}),
    (96000, 96000, [12000.0], {}),
    (96000, 192000, [12000.0, 9000.0], {}),
    (96000, 460800, [21000.0], {}),
    (96000, 76800, [12000.0], {}),
    (96000, 57600, [12000.0], {}),
    (192000, 192000, [12000.0], {}),
    (192000, 96000, [12000.0], {}),
    (192000, 38400, [9000.0], {}),
    (96000, 192000, [12345.0], {}),
    (96000, 192000, [1200.0], {}),
    (96000, 192000, [12000.05], {}),
    (96000, 192000, [12000.0], {"dofft": True}),
    (96000, 192000, [12000.0], {"fuse_mf": True}),
    (96000, 192000, [12000.0], {"compat_scan": True}),
])
def test_eligibility_matches_jax(monkeypatch, rate, t_len, tunings, flags):
    """The port picks the merged kernel exactly where the reference does."""
    cfg = JB.BpskConfig(rate=rate, tuning=tunings[0], **flags)
    tcfg = TB.BpskConfig(rate=rate, tuning=tunings[0], **flags)
    assert (TB.spectrum_step_merged(tcfg, t_len, np.asarray(tunings))
            == _jax_branch(monkeypatch, cfg, t_len, np.asarray(tunings)))


def test_what_still_raises():
    """Every tuning mode and compat_scan take a branch now
    (tests/test_torch_compat_scan.py holds compat_scan's); a block that is
    not whole bit periods raises."""
    cfg = TB.BpskConfig(rate=96000)
    st = TB.bpsk_init_batch(cfg, 1, "cpu")
    x = CF(torch.zeros(1, 38400), torch.zeros(1, 38400))
    for tun, flags in ((12345.0, {}), (12000.05, {}), (12000.0,
                                                      {"dofft": True})):
        TB.bpsk_block_batch_spectrum(x, cfg._replace(**flags), st, [tun])
    _, out, _ = TB.bpsk_block_batch_spectrum(
        x, cfg._replace(compat_scan=True), st)
    assert int(out.n_bits[0]) == 0
    with pytest.raises(ValueError, match="multiple of 8"):
        TB.bpsk_block_batch_spectrum(CF(x.re[:, :38360], x.im[:, :38360]),
                                     cfg, st)


@pytest.mark.parametrize("tunings,flags", [
    ([12000.5, 1200.0], {}),                       # general
    ([12000.0, 12000.0], {"dofft": True}),          # dofft
    ([12000.0, 12000.0], {"dofft": True, "track_high": True}),
    ([12730.0, 26230.0], {"rate": 192000, "carrier": 12730.0}),  # general
])
def test_staged_step_in_every_mode_matches_jax(tunings, flags):
    """The general and dofft (lower and upper half-band) deployments take
    the staged branch in both packages, 1 s blocks chained over the
    frame: waterfalls, peaks, decisions, state and the payload as in
    test_spectrum_step_matches_jax; the waterfall is the pattern-mode
    step's, bit for bit, since it does not depend on the tuner. The last
    case is the 192 kS/s station with its tabs off the 1500 Hz grid, its
    frame on tab 0's carrier (96 kS/s and 12 kHz where ``flags`` name no
    rate and carrier)."""
    flags = dict(flags)
    rate = flags.pop("rate", 96000)
    block = rate
    payload, iq = _frame(rate, block, flags.pop("carrier", 12000.0))
    cfg = JB.BpskConfig(rate=rate, tuning=tunings[0], **flags)
    tcfg = TB.BpskConfig(rate=rate, tuning=tunings[0], **flags)
    assert not TB.spectrum_step_merged(tcfg, 2 * block, np.asarray(tunings))
    st_j = jax.tree.map(np.asarray, JB.bpsk_init_batch(cfg, 2))
    st_t = TB.state_from_numpy(st_j, "cpu")
    st_p = TB.bpsk_init_batch(TB.BpskConfig(rate=rate), 2, "cpu")
    payloads = []
    for b in range(iq.shape[1] // block):
        blk = iq[:, b * block:(b + 1) * block]
        spec_j, out_j, st_j = JB.bpsk_block_batch_spectrum(
            blk, cfg, st_j, np.asarray(tunings), use_pallas=False)
        st_j = jax.tree.map(np.asarray, st_j)
        spec_t, out_t, st_t = TB.bpsk_block_batch_spectrum(
            _cf(blk), tcfg, st_t, tunings)
        spec_p, _out, st_p = TB.bpsk_block_batch_spectrum(
            _cf(blk), TB.BpskConfig(rate=rate), st_p)
        for name in ("wf", "peak_db", "peak_freq"):
            assert torch.equal(getattr(spec_t, name), getattr(spec_p, name))
        np.testing.assert_allclose(spec_t.wf.numpy(), np.asarray(spec_j.wf),
                                   rtol=0, atol=0.2)
        np.testing.assert_allclose(spec_t.peak_db.numpy(),
                                   np.asarray(spec_j.peak_db), atol=1e-3)
        np.testing.assert_array_equal(spec_t.peak_freq.numpy(),
                                      np.asarray(spec_j.peak_freq))
        _assert_step_equal(out_t, st_t, out_j, st_j,
                           ds_rel=5e-6 if flags else 1e-6)
        np.testing.assert_array_equal(
            st_t.fft_tuner.centre_bin.numpy(),
            np.asarray(st_j.fft_tuner.centre_bin))
        nh = int(out_t.n_hits[0])
        if nh:
            res = fec_decode(out_t.windows[0, :nh])
            payloads += [bytes(p) for ok, p in
                         zip(res.ok.numpy(), res.payload.numpy()) if ok]
    assert payloads == [payload.tobytes()] * (not flags.get("track_high"))


def test_fuse_mf_takes_the_staged_branch():
    """With ``fuse_mf`` a block the merged kernel could take goes through
    the staged pair, as the reference's rule says (bpsk.py:1082):
    spectrum_waterfall, then bpsk_block_batch with the fused matched
    filter, bit for bit; and the frame decodes."""
    rate, block = 96000, 192000
    payload, iq = _frame(rate, block)
    tun = np.array([12000.0, 12000.0])
    cfg = TB.BpskConfig(rate=rate, tuning=12000.0, fuse_mf=True)
    assert not TB.spectrum_step_merged(cfg, block, tun)
    st_m = st_s = TB.bpsk_init_batch(cfg, 2, "cpu")
    payloads = []
    for b in range(iq.shape[1] // block):
        x = _cf(iq[:, b * block:(b + 1) * block])
        spec, out_m, st_m = TB.bpsk_block_batch_spectrum(x, cfg, st_m)
        want = TB._waterfall_out(*spectrum_waterfall(x, rate // 10), rate)
        out_s, st_s = TB.bpsk_block_batch(x, cfg, st_s, tun)
        for name in ("wf", "peak_db", "peak_freq"):
            assert torch.equal(getattr(spec, name), getattr(want, name)), name
        for a, b_ in zip(out_m, out_s):
            assert torch.equal(a, b_)
        nh = int(out_m.n_hits[0])
        if nh:
            res = fec_decode(out_m.windows[0, :nh])
            payloads += [bytes(p) for ok, p in
                         zip(res.ok.numpy(), res.payload.numpy()) if ok]
    assert payloads == [payload.tobytes()]
