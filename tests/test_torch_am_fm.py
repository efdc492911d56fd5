"""The port's AM/NFM/WFM demodulator (``jsdr_tpu_torch/demod/am_fm.py``)
and FIR design (``ops/fir.py``) against the JAX package's, on the same
seeded numpy inputs, on the CPU.

Tolerances (the reference runs its FIR as a banded matmul, the port as a
``conv1d``, so sums differ in order; cos/sin may differ by an ulp):

- ``fir_tail`` bit-equal (input samples); ``bandpass_weights`` bit-equal
  as float32 (both designed in float64 numpy);
- float audio within 2e-5 absolute after AGC, and within 2e-5 of the
  block's max |audio| without it;
- ``mx`` and ``avg`` within 1e-5 relative; ``car`` within 1e-5 rad after
  50 chained blocks; ``last_iq`` within 1e-5 absolute;
- S16 output: every sample within 1 count, at least 99.9% equal (AM:
  99.5%, see ``AM_EQUAL``); ``audio_to_s16_stereo`` of the same floats
  byte-equal;
- ``fir_apply``/``fir_apply_fft`` within 1e-6 of the output's max
  (unit-scale input, 21 taps).
- ``fir_precision="bf16x3"`` (three bf16 matmul passes in the reference,
  true float32 here) within 1e-4 absolute after AGC: the reference's
  dropped lo*lo term is ~2^-16 relative per product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsdr_tpu.demod import am_fm as J
from jsdr_tpu.ops import fir as JF
from jsdr_tpu.ops.cplx import CF as JCF
from jsdr_tpu.ops.cplx import from_complex as j_from_complex
from jsdr_tpu_torch.demod import am_fm as T
from jsdr_tpu_torch.ops import fir as TF
from jsdr_tpu_torch.ops.cplx import CF

RATE = 96000
# AM's S16 samples: at least 99.5% equal (not 99.9%). The block mean is
# subtracted from every sample, and the two packages' float32 means of
# 19,200 values (each summed in its own order) differ by ~1e-7 relative,
# as the reference's mean differs from the exact one; that shifts every
# sample by ~2e-3 counts, so ~0.2% of them cross a truncation boundary.
AM_EQUAL = 0.995
# n * flo / rate is not an integer at the test lengths, so the carried
# phase moves (at flo = -8000 and T = 19200 it would land on 0 every block)
FLO, FHI = -7333, 9000


def _noise(rng, shape, scale=0.3):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def _cf(x):
    return CF(torch.from_numpy(np.ascontiguousarray(x.real, np.float32)),
              torch.from_numpy(np.ascontiguousarray(x.imag, np.float32)))


def _cfg(mode, dofir, dodwn, doagc, **kw):
    band = dict(flo=FLO, fhi=FHI) if (dofir or dodwn) else {}
    return J.AmFmConfig(rate=RATE, mode=int(mode), dofir=dofir,
                        dodwn=dodwn, doagc=doagc, **band, **kw)


def _jax_batch_state(cfg, s):
    return jax.tree.map(lambda a: np.broadcast_to(
        np.asarray(a), (s, *np.shape(a))).copy(), J.AmFmState.init(cfg))


def _check_audio(got, want, doagc):
    got, want = np.asarray(got), np.asarray(want)
    if doagc:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    else:
        scale = np.abs(want).max(axis=-1, keepdims=True)
        assert (np.abs(got - want) <= 2e-5 * scale).all()


def _check_s16(got, want, equal=0.999):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= equal


def _check_state(got, want):
    np.testing.assert_array_equal(got.fir_tail.re.numpy(),
                                  np.asarray(want.fir_tail.re))
    np.testing.assert_array_equal(got.fir_tail.im.numpy(),
                                  np.asarray(want.fir_tail.im))
    np.testing.assert_allclose(got.car.numpy(), np.asarray(want.car),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.last_iq.numpy(), np.asarray(want.last_iq),
                               rtol=0, atol=1e-5)


def _check_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert (np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-30).all()


@pytest.mark.parametrize("doagc", [False, True], ids=["noagc", "agc"])
@pytest.mark.parametrize("dodwn", [False, True], ids=["nodwn", "dwn"])
@pytest.mark.parametrize("dofir", [False, True], ids=["nofir", "fir"])
@pytest.mark.parametrize("mode", list(J.Mode), ids=lambda m: m.name)
def test_batched_block_matches_jax_vmap(mode, dofir, dodwn, doagc):
    """4 streams x 19,200 through the port's [S, T] call and through
    ``jax.vmap`` of the reference's ``demod_block`` (as bench.py calls
    it): audio, max, mean, S16 output and every state leaf."""
    rng = np.random.default_rng(100 + 8 * int(mode) + 4 * dofir
                                + 2 * dodwn + doagc)
    s, n = 4, 19200
    cfg = _cfg(mode, dofir, dodwn, doagc)
    x = _noise(rng, (s, n))
    st = _jax_batch_state(cfg, s)
    # a carried state from an earlier block: nonzero tail, phase, last_iq
    st = st._replace(
        fir_tail=j_from_complex(_noise(rng, (s, cfg.ntaps - 1))),
        car=rng.uniform(0, 2 * np.pi, s).astype(np.float32),
        last_iq=rng.standard_normal((s, 2)).astype(np.float32) * 0.3)
    ja, jm, jv, jst = jax.vmap(lambda a, b: J.demod_block(a, cfg, b))(
        j_from_complex(x), st)
    ta, tm, tv, tst = T.demod_block(_cf(x), T.AmFmConfig(*cfg),
                                    T.state_from_numpy(st, "cpu"))
    assert ta.shape == (s, n) and tm.shape == tv.shape == (s,)
    _check_audio(ta.numpy(), ja, doagc)
    _check_rel(tm.numpy(), jm)
    _check_rel(tv.numpy(), jv)
    _check_state(tst, jst)
    _check_s16(T.audio_to_s16_stereo(ta).numpy(),
               J.audio_to_s16_stereo(ja),
               AM_EQUAL if mode == J.Mode.AM else 0.999)


@pytest.mark.parametrize("mode", list(J.Mode), ids=lambda m: m.name)
def test_unbatched_block_matches_jax(mode):
    """A [T] block with every option on: the reference's unbatched call,
    and the state's unbatched shapes."""
    rng = np.random.default_rng(7 + int(mode))
    cfg = _cfg(mode, True, True, True)
    x = _noise(rng, 9601)
    ja, jm, jv, jst = J.demod_block(x, cfg, J.AmFmState.init(cfg))
    st = T.AmFmState.init(T.AmFmConfig(*cfg), "cpu")
    assert (st.fir_tail.re.shape, st.car.shape, st.last_iq.shape) == (
        (20,), (), (2,))
    ta, tm, tv, tst = T.demod_block(_cf(x), T.AmFmConfig(*cfg), st)
    assert ta.shape == (9601,) and tm.shape == tv.shape == ()
    _check_audio(ta.numpy(), ja, True)
    _check_rel(tm.numpy(), jm)
    _check_rel(tv.numpy(), jv)
    _check_state(tst, jst)


@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
def test_fir_precision_values(precision):
    """Both reference FIR precisions against the port's (true float32 for
    either value): WFM with the FIR and AGC on, 2 streams."""
    rng = np.random.default_rng(31)
    cfg = _cfg(J.Mode.WFM, True, True, True, fir_precision=precision)
    x = _noise(rng, (2, 9600))
    ja, _, _, jst = jax.vmap(lambda a, b: J.demod_block(a, cfg, b))(
        j_from_complex(x), _jax_batch_state(cfg, 2))
    tcfg = T.AmFmConfig(*cfg)
    ta, _, _, tst = T.demod_block(_cf(x), tcfg,
                                  T.AmFmState.init(tcfg, "cpu", 2))
    tol = 2e-5 if precision == "highest" else 1e-4
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=tol)
    _check_state(tst, jst)


def test_carried_phase_over_50_chained_blocks():
    """50 chained blocks of 1,001 samples (the carried phase moves by a
    non-integer number of turns each block): the phase stays within 1e-5
    rad of the reference's, and every block's audio within tolerance."""
    rng = np.random.default_rng(5)
    cfg = _cfg(J.Mode.NFM, True, True, True)
    tcfg = T.AmFmConfig(*cfg)
    jst, tst = J.AmFmState.init(cfg), T.AmFmState.init(tcfg, "cpu")
    for _ in range(50):
        x = _noise(rng, 1001)
        ja, _, _, jst = J.demod_block(x, cfg, jst)
        ta, _, _, tst = T.demod_block(_cf(x), tcfg, tst)
        _check_audio(ta.numpy(), ja, True)
    assert abs(float(tst.car) - float(jst.car)) <= 1e-5
    assert float(tst.car) != 0.0
    _check_state(tst, jst)


def test_mod_2pi_equals_jnp_mod():
    """The carried phase's floor-mod against ``jnp.mod`` on float32 values
    across several turns on both sides, exact zeros and values one ulp
    around multiples of 2pi: bit-equal. (Normal floats only: the
    reference's CPU backend treats subnormal inputs as zero.)"""
    rng = np.random.default_rng(2)
    two_pi = np.float32(2 * np.pi)
    edges = np.array([two_pi, -two_pi, 3 * two_pi, -1e-8, 1e-8], np.float32)
    near = np.concatenate([np.nextafter(edges, np.float32(np.inf)),
                           np.nextafter(edges, np.float32(-np.inf)),
                           np.float32([0.0, -0.0])])
    x = np.concatenate([rng.uniform(-40, 40, 5000).astype(np.float32),
                        edges, near])
    got = T._mod_2pi(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.mod(jnp.asarray(x), 2 * np.pi))
    assert got.tobytes() == want.tobytes()


def test_audio_to_s16_stereo_clip_edges():
    """Clip, truncation toward zero and interleave, byte-equal to the
    reference on the clip edges, the rounding edges and noise, [T] and
    [S, T]."""
    lim = np.float32(1 / 32767)
    edges = np.array([-2.0, -1.0001, -1.0, -32768 / 32767, -0.5, -lim,
                      -0.5 * lim, 0.0, 0.5 * lim, lim, 0.5, 0.99999, 1.0,
                      1.0001, 2.0, np.inf, -np.inf], np.float32)
    noise = np.random.default_rng(3).uniform(-1.2, 1.2, (3, 500)).astype(
        np.float32)
    for a in (edges, noise):
        got = T.audio_to_s16_stereo(torch.from_numpy(a)).numpy()
        want = np.asarray(J.audio_to_s16_stereo(jnp.asarray(a)))
        assert got.dtype == np.int16 and got.tobytes() == want.tobytes()
    got = T.audio_to_s16_stereo(torch.tensor([0.5, -0.25])).numpy()
    assert list(got) == [16383, 16383, -8191, -8191]


@pytest.mark.parametrize("ntaps,flo,fhi,rate", [
    (21, -3000, 3000, 96000), (21, 8000, 12000, 96000),
    (21, -20000, 20000, 96000), (21, -3000.0, 3000.0, 44100.0),
    (33, 1000, 5000, 48000), (21, None, None, 96000)])
def test_bandpass_weights_bit_equal(ntaps, flo, fhi, rate):
    got = TF.bandpass_weights(ntaps, flo, fhi, float(rate), device="cpu")
    want = np.asarray(JF.bandpass_weights(ntaps, flo, fhi, float(rate)))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert got.numpy().tobytes() == want.tobytes()


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("kind", ["real", "complex", "cf", "batched_cf"])
@pytest.mark.parametrize("band", [(-3000, 9000), (None, None)],
                         ids=["bandpass", "allpass"])
def test_fir_apply_matches_reference(kind, band):
    rng = np.random.default_rng(17)
    taps = TF.bandpass_weights(21, *band, 96000.0, device="cpu")
    jtaps = JF.bandpass_weights(21, *band, 96000.0)
    x = _noise(rng, (3, 4000) if kind == "batched_cf" else 4000, 1.0)
    if kind == "real":
        _close(TF.fir_apply(torch.from_numpy(x.real.copy()), taps),
               JF.fir_apply(jnp.asarray(x.real), jtaps))
    elif kind == "complex":
        _close(TF.fir_apply(torch.from_numpy(x), taps),
               JF.fir_apply(jnp.asarray(x), jtaps))
    else:
        got = TF.fir_apply(_cf(x), taps)
        want = JF.fir_apply(j_from_complex(x), jtaps)
        _close(got.re, want.re)
        _close(got.im, want.im)
    if band[0] is None:      # the all-pass delays by the centre tap
        y = TF.fir_apply(torch.from_numpy(x.real.copy()), taps).numpy()
        np.testing.assert_array_equal(y[..., 10:], x.real[..., :-10])


@pytest.mark.parametrize("kind", ["real", "cf"])
def test_fir_apply_fft_matches_reference(kind):
    rng = np.random.default_rng(19)
    taps = TF.bandpass_weights(21, 2000, 12000, 96000.0, device="cpu")
    jtaps = JF.bandpass_weights(21, 2000, 12000, 96000.0)
    x = _noise(rng, (2, 3000), 1.0)
    if kind == "real":
        got = TF.fir_apply_fft(torch.from_numpy(x.real.copy()), taps)
        assert not isinstance(got, CF)
        _close(got, JF.fir_apply_fft(jnp.asarray(x.real), jtaps))
        _close(got, TF.fir_apply(torch.from_numpy(x.real.copy()), taps))
    else:
        got = TF.fir_apply_fft(_cf(x), taps)
        want = JF.fir_apply_fft(j_from_complex(x), jtaps)
        _close(got.re, want.re)
        _close(got.im, want.im)


def test_state_numpy_round_trips():
    """``state_from_numpy`` of the reference's numpy state (unbatched and
    [S, ...]) and of a JAX step's output, and ``state_to_numpy`` back:
    the same leaves in ``jax.tree`` order, and the JAX state rebuilt from
    the port's continues like the reference's own."""
    cfg = _cfg(J.Mode.WFM, True, True, True)
    tcfg = T.AmFmConfig(*cfg)
    for jst, tst in ((J.AmFmState.init(cfg), T.AmFmState.init(tcfg, "cpu")),
                     (_jax_batch_state(cfg, 3),
                      T.AmFmState.init(tcfg, "cpu", 3))):
        got = T.state_from_numpy(jst, "cpu")
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tst)):
            assert torch.equal(a, b)
    rng = np.random.default_rng(23)
    x1, x2 = _noise(rng, 5000), _noise(rng, 5000)
    _, _, _, jst = J.demod_block(x1, cfg, J.AmFmState.init(cfg))
    tst = T.state_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    for a, b in zip(jax.tree.leaves(tst), jax.tree.leaves(jst)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = J.AmFmState(*jax.tree.unflatten(
        jax.tree.structure(tuple(jst)),
        jax.tree.leaves(T.state_to_numpy(tst))))
    back = back._replace(fir_tail=JCF(*back.fir_tail))
    ja, _, _, _ = J.demod_block(x2, cfg, back)
    jb, _, _, _ = J.demod_block(x2, cfg, jst)
    np.testing.assert_array_equal(np.asarray(ja), np.asarray(jb))
    ta, _, _, _ = T.demod_block(_cf(x2), tcfg, tst)
    _check_audio(ta.numpy(), jb, True)


# -- the reference's known answers (tests/test_demod.py) through the port --

def _run(iq, cfg):
    st = T.AmFmState.init(cfg, "cpu")
    return T.demod_block(_cf(np.asarray(iq, np.complex64)), cfg, st)


def test_am_demod_recovers_envelope():
    t = np.arange(RATE) / RATE
    mod = 1.0 + 0.5 * np.sin(2 * np.pi * 1000 * t)
    iq = 0.4 * mod * np.exp(2j * np.pi * 5000 * t)
    audio, mx, avg, _ = _run(iq, T.AmFmConfig(rate=RATE, mode=int(T.Mode.AM)))
    spec = np.abs(np.fft.rfft(audio.numpy()))
    assert np.argmax(spec[100:]) + 100 == 1000
    assert abs(float(avg) - 0.4) < 0.01


def test_fm_demod_recovers_tone():
    t = np.arange(RATE) / RATE
    phase = 2 * np.pi * np.cumsum(4000.0 * np.sin(2 * np.pi * 800 * t)) / RATE
    audio, _, _, _ = _run(0.5 * np.exp(1j * phase),
                          T.AmFmConfig(rate=RATE, mode=int(T.Mode.NFM)))
    spec = np.abs(np.fft.rfft(audio.numpy()))
    assert np.argmax(spec[100:]) + 100 == 800


def test_fm_state_chains_blocks():
    """Two chained half blocks, and ten chained 0.1 s blocks, equal one
    1 s block, with the FIR and the down-shift on (their state carried)."""
    from jsdr_tpu_torch.io.sources import synth_sine
    iq = synth_sine(RATE, 2000.0, RATE, amplitude=0.5)
    cfg = T.AmFmConfig(rate=RATE, mode=int(T.Mode.NFM), dofir=True,
                       dodwn=True, flo=-7333, fhi=9000)
    whole, _, _, wst = _run(iq, cfg)
    for n_parts in (2, 10):
        st, got = T.AmFmState.init(cfg, "cpu"), []
        for part in np.split(iq, n_parts):
            a, _, _, st = T.demod_block(_cf(part), cfg, st)
            got.append(a.numpy())
        _check_audio(np.concatenate(got), whole.numpy(), False)
        d = abs(float(st.car) - float(wst.car))      # as angles
        assert min(d, 2 * np.pi - d) <= 1e-5


def test_fir_select_plus_downshift():
    from jsdr_tpu_torch.io.sources import synth_sine
    iq = (synth_sine(RATE, 10000.0, RATE, amplitude=0.4)
          + synth_sine(RATE, 30000.0, RATE, amplitude=0.4))
    cfg = T.AmFmConfig(rate=RATE, mode=int(T.Mode.RAW), dofir=True,
                       dodwn=True, flo=8000, fhi=12000)
    audio, _, _, _ = _run(iq, cfg)
    spec = np.abs(np.fft.fft(audio.numpy()))
    assert abs(np.argmax(spec[:RATE // 2]) - 2000) < 20
