"""The port's streaming Session (``runtime/executor.py``), its device
conversion (``io/convert_device.py``) and its stages on the CPU, mirroring
the reference's own tests (tests/test_io_runtime.py:286-310, 313-382,
452-565): frames, retry and drop, the recorder round trip, raw device
conversion equal to the host's, ``sync_every`` drains and the merged
stage's topics; then the port's Session against the JAX package's on the
same chunks: ``SpectrumStage(waterfall_width=960)``'s published PSD and
lines, the telemetry frames with and without ``fuse_mf``, and
``DemodStage``'s audio and checkpoints (``AudioSinkStage`` after it)."""

import functools

import numpy as np
import pytest
import torch

from jsdr_tpu.io import convert as j_convert
from jsdr_tpu_torch.demod.bpsk import BpskConfig
from jsdr_tpu_torch.io import sources
from jsdr_tpu_torch.io.convert_device import s16_to_cf, upload_raw
from jsdr_tpu_torch.runtime.executor import (AudioSinkStage, DemodStage,
                                             RecorderStage, Session,
                                             SpectrumStage,
                                             SpectrumTelemetryStage, Stage,
                                             TelemetryStage)


@functools.lru_cache(maxsize=None)
def _frame_signal() -> np.ndarray:
    """One AO-40 frame (payload 0..255) at 12 kHz, padded to whole 1 s
    blocks at 96 kS/s (the reference tests' signal)."""
    payload = np.arange(256, dtype=np.uint8)[None]
    sig = sources.synth_bpsk_stream(payload, rate=96000, preamble_bits=300)
    return np.concatenate([sig, np.zeros((-len(sig)) % 96000, np.complex64)])


def _listen(session, *topics):
    got = {t: [] for t in topics}
    session.pubsub.listen(lambda t, v: got[t].append(v) if t in got
                          else None)
    return got


def test_streaming_executor_session():
    sig = _frame_signal()
    chunks = (sig[i:i + 48000] for i in range(0, len(sig), 48000))
    s = Session(source=chunks, block_samples=96000, device="cpu")
    got = _listen(s, "telemetry-frame", "fft-psd")
    n = s.run([SpectrumStage(96000),
               TelemetryStage(BpskConfig(rate=96000, tuning=12000.0),
                              device="cpu")])
    assert n == len(sig) // 96000
    assert len(got["fft-psd"]) == n
    frames = got["telemetry-frame"]
    assert len(frames) == 1 and frames[0]["ok"]
    assert np.array_equal(frames[0]["payload"], np.arange(256))
    assert s.timers.report()["telemetry"]["samples"] == n * 96000
    assert s.device == torch.device("cpu") and s.dropped_blocks == {}


def test_device_side_conversion_matches_host():
    import jax.numpy as jnp
    from jsdr_tpu.io.convert_device import s16_to_cf as j_s16_to_cf
    from jsdr_tpu.ops.cplx import to_complex

    rng = np.random.default_rng(1234)

    def port(s, i_corr, q_corr, channels=2):
        cf = s16_to_cf(upload_raw(s, "cpu"), i_corr, q_corr, channels)
        return (cf.re.numpy() + 1j * cf.im.numpy()).astype(np.complex64)

    s = rng.integers(-32768, 32768, 4096, dtype=np.int16)
    big = np.full(64, 32000, dtype=np.int16)
    mono = rng.integers(-32768, 32768, 128, dtype=np.int16)
    for data, ic, qc, ch in ((s, 3, -5, 2), (big, 2000, -40000, 2),
                             (mono, 0, 0, 1), (mono, 7, 0, 1),
                             (mono, 7, 9, 1)):
        got = port(data, ic, qc, ch)
        want = to_complex(j_s16_to_cf(jnp.asarray(data), jnp.int32(ic),
                                      jnp.int32(qc), channels=ch))
        assert np.array_equal(got, want)
        host = j_convert.s16le_to_complex(data, ch, ic, qc)
        # the reference's host converter leaves a mono Q at 0 whatever
        # q_corr is; its device converter (ported here) adds q_corr to it
        # (ROADMAP.md, queue 3)
        assert np.array_equal(got, host) == (ch == 2 or qc == 0)
    assert np.array_equal(port(s.tobytes(), 1, 1), port(s, 1, 1))


def test_executor_retry_restores_state_and_counts_drops():
    """A failing stage retries against the state it started the block
    with, and on a double failure restores state, counts the drop and
    publishes a gap marker (the reference's behaviour)."""
    sig = sources.synth_noise(4 * 1024, seed=0)

    class FlakyStage(Stage):
        name = "flaky"

        def __init__(self):
            self.state = 0
            self.calls = 0

        def process(self, block, session):
            self.calls += 1
            start = self.state
            self.state = start + 1          # advance BEFORE failing
            if self.calls == 2:             # first attempt at block 1 dies
                raise RuntimeError("transient")

    class DeadStage(Stage):
        name = "dead"

        def __init__(self):
            self.state = 123

        def process(self, block, session):
            self.state = 999
            raise RuntimeError("always")

    flaky, dead = FlakyStage(), DeadStage()
    s = Session(source=iter([sig]), block_samples=1024, device="cpu")
    markers = _listen(s, "dropped-block")["dropped-block"]
    assert s.run([flaky, dead]) == 4
    assert flaky.calls == 5 and flaky.state == 4
    assert dead.state == 123
    assert s.dropped_blocks == {"dead": 4}
    assert [m["block"] for m in markers] == [0, 1, 2, 3]
    assert markers[-1]["total"] == 4


def test_recorder_stage_roundtrip(tmp_path):
    iq = sources.synth_sine(4800, 1000.0, 9600.0, amplitude=0.5)
    path = tmp_path / "cap.raw"
    stage = RecorderStage(path)
    session = Session(source=iter([iq]), block_samples=960, device="cpu")
    assert session.run([stage]) == 5
    stage.close()
    back = sources.FileSource(path, rate=9600).all()
    assert len(back) == 4800
    np.testing.assert_allclose(back.real, iq[:4800].real, atol=1.01 / 32767)
    np.testing.assert_allclose(back.imag, iq[:4800].imag, atol=1.01 / 32767)


def test_raw_session_device_convert_and_raw_record_tap(tmp_path):
    rng = np.random.default_rng(1234)
    data = rng.integers(-32768, 32768, 2 * 4800, dtype=np.int16)
    cap = tmp_path / "cap.raw"
    cap.write_bytes(data.astype("<i2").tobytes())
    seen = []

    class Probe(Stage):
        name = "probe"

        def process(self, block, session):
            seen.append((block.re.numpy(), block.im.numpy()))

    rec = RecorderStage(tmp_path / "rec.raw")
    session = Session(source=sources.FileSource(cap, rate=9600)
                      .raw_blocks(960), block_samples=960, i_corr=2,
                      q_corr=-5, device="cpu")
    assert session.run([Probe(), rec]) == 5
    rec.close()
    assert (tmp_path / "rec.raw").read_bytes() == cap.read_bytes()
    host = j_convert.s16le_to_complex(data, 2, 2, -5)
    got = np.concatenate([r + 1j * q for r, q in seen]).astype(np.complex64)
    assert np.array_equal(got, host.astype(np.complex64))


def test_telemetry_sync_every_defers_readbacks():
    sig = _frame_signal()
    n_blocks = len(sig) // 96000
    s = Session(source=iter([sig]), block_samples=96000, device="cpu")
    got = _listen(s, "telemetry-frame", "telemetry-counters")
    stage = TelemetryStage(BpskConfig(rate=96000, tuning=12000.0),
                           sync_every=3, device="cpu")
    assert s.run([stage]) == n_blocks
    # drains: one per full 3-block group + the finish() flush
    assert len(got["telemetry-counters"]) == -(-n_blocks // 3)
    assert got["telemetry-counters"][-1][0] == (n_blocks * 96000,
                                                n_blocks * 9600,
                                                *stage.state.counters[0, 2:]
                                                .tolist())
    frames = got["telemetry-frame"]
    assert len(frames) == 1 and frames[0]["ok"]
    assert np.array_equal(frames[0]["payload"], np.arange(256))


def test_spectrum_telemetry_stage_one_pass():
    sig = _frame_signal()
    s = Session(source=iter([sig]), block_samples=96000, device="cpu")
    got = _listen(s, "telemetry-frame", "waterfall-line", "fft-peak")
    stage = SpectrumTelemetryStage(BpskConfig(rate=96000, tuning=12000.0),
                                   sync_every=2, device="cpu")
    assert s.run([stage]) == len(sig) // 96000
    frames = got["telemetry-frame"]
    assert len(frames) == 1 and frames[0]["ok"]
    assert np.array_equal(frames[0]["payload"], np.arange(256))
    assert got["waterfall-line"][0].shape == (10, 1920)
    # the BPSK carrier sits at 12 kHz + 1200 Hz
    assert any(abs(p[0] - 13200) < 1300 for p in got["fft-peak"])


def test_stage_and_session_devices():
    cfg = BpskConfig(rate=96000)
    with pytest.raises(NotImplementedError, match="parallel"):
        TelemetryStage(cfg, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="parallel"):
        TelemetryStage.block_samples_for(cfg, mesh=object())
    assert TelemetryStage.block_samples_for(cfg) == 96000

    class OnMeta(Stage):
        name = "meta-stage"
        device = torch.device("meta")

    s = Session(source=iter([np.zeros(96000, np.complex64)]),
                block_samples=96000, device="cpu")
    with pytest.raises(ValueError, match="meta-stage"):
        s.run([OnMeta()])


def test_spectrum_stage_waterfall_matches_the_jax_session():
    """PSD within 2e-3 dB at or above each row's median (torch.fft against
    the reference's matmul DFT); lines within one count, and equal on at
    least 99% of pixels (a 2e-3 dB difference moves a truncated intensity
    across an integer on a few pixels)."""
    from jsdr_tpu.runtime.executor import SpectrumStage as JSpectrumStage

    sig = sources.synth_bpsk_stream(np.arange(256, dtype=np.uint8)[None],
                                    rate=96000, preamble_bits=200,
                                    noise_rms=0.25, seed=3)[:3 * 96000]
    chunks = [sig[i:i + 32000] for i in range(0, len(sig), 32000)]
    from jsdr_tpu.runtime.executor import Session as JSession

    port, ref = [], []
    for cls, stage, out, kw in (
            (Session, SpectrumStage(96000, waterfall_width=960), port,
             {"device": "cpu"}),
            (JSession, JSpectrumStage(96000, waterfall_width=960), ref, {})):
        s = cls(source=iter(chunks), block_samples=96000, **kw)
        out.append(_listen(s, "fft-psd", "waterfall-line"))
        s.run([stage])
    port, ref = port[0], ref[0]
    assert len(port["fft-psd"]) == len(ref["fft-psd"]) == 3
    for p, r in zip(port["fft-psd"], ref["fft-psd"]):
        assert p.shape == r.shape == (10, 9600) and p.dtype == np.float32
        floor = np.median(r, axis=1, keepdims=True)
        assert np.abs(p - r)[r >= floor].max() <= 2e-3
    lines_p = np.stack(port["waterfall-line"]).astype(int)
    lines_r = np.stack(ref["waterfall-line"]).astype(int)
    assert lines_p.shape == lines_r.shape == (3, 10, 960)
    assert np.abs(lines_p - lines_r).max() <= 1
    assert (lines_p == lines_r).mean() >= 0.99


@functools.lru_cache(maxsize=None)
def _two_frame_chunks():
    """Raw int16 chunks of one stream carrying two frames (at 6 and
    18 kHz, payloads from a seed), and the payloads."""
    rng = np.random.default_rng(8)
    pay = rng.integers(0, 256, (2, 256), dtype=np.uint8)
    sig = sum(sources.synth_bpsk_stream(pay[i:i + 1], rate=96000,
                                        carrier_offset=tu, preamble_bits=200,
                                        amplitude=0.4, seed=i)
              for i, tu in enumerate((6000.0, 18000.0)))
    sig = np.concatenate([sig, np.zeros((-len(sig)) % 96000, np.complex64)])
    raw = np.frombuffer(j_convert.complex_to_s16le(sig), "<i2")
    return [raw[i:i + 64000] for i in range(0, len(raw), 64000)], pay


TWO_FRAME_TUNINGS = (18000.0, 6000.0, 18000.0)


@functools.lru_cache(maxsize=None)
def _jax_telemetry_session():
    """The JAX package's Session over _two_frame_chunks (run once)."""
    from jsdr_tpu.demod.bpsk import BpskConfig as JConfig
    from jsdr_tpu.runtime.executor import Session as JSession
    from jsdr_tpu.runtime.executor import TelemetryStage as JTelemetryStage

    s = JSession(source=iter(_two_frame_chunks()[0]), block_samples=96000,
                 i_corr=3, q_corr=-2)
    got = _listen(s, "telemetry-frame", "telemetry-counters")
    s.run([JTelemetryStage(JConfig(rate=96000), list(TWO_FRAME_TUNINGS),
                           sync_every=4)])
    assert s.dropped_blocks == {}
    return got


@pytest.mark.parametrize("fuse_mf", [False, True])
def test_telemetry_frames_match_the_jax_session(fuse_mf):
    """Three instances on one raw int16 stream carrying two frames
    (device conversion), each instance tuned to a carrier: the same frames
    (instance, corr, ok, errors, payload) and counters as the JAX
    Session's unfused chain. (An instance tuned away from every carrier
    demodulates noise, where timing decisions sit on near-ties that
    another summation order may flip: ROADMAP.md, queue 3.)"""
    chunks, pay = _two_frame_chunks()
    s = Session(source=iter(chunks), block_samples=96000, i_corr=3,
                q_corr=-2, device="cpu")
    port = _listen(s, "telemetry-frame", "telemetry-counters")
    s.run([TelemetryStage(BpskConfig(rate=96000, fuse_mf=fuse_mf),
                          TWO_FRAME_TUNINGS, sync_every=4, device="cpu")])
    assert s.dropped_blocks == {}
    ref = _jax_telemetry_session()
    assert port["telemetry-counters"] == ref["telemetry-counters"]
    assert len(port["telemetry-frame"]) == len(ref["telemetry-frame"]) >= 1
    for p, r in zip(port["telemetry-frame"], ref["telemetry-frame"]):
        assert {k: v for k, v in p.items() if k != "payload"} == {
            k: v for k, v in r.items() if k != "payload"}
        assert np.array_equal(p["payload"], r["payload"])
    ok = [(f["demod"], f["payload"].tobytes())
          for f in port["telemetry-frame"] if f["ok"]]
    assert sorted(ok) == [(0, pay[1].tobytes()), (1, pay[0].tobytes()),
                          (2, pay[1].tobytes())]


def test_checkpoint_resume_equals_an_uninterrupted_run(tmp_path):
    """A checkpoint written after k blocks and loaded by a new Session ends
    with the counters, frames and state of an uninterrupted run."""
    from jsdr_tpu_torch.runtime.state import tree_leaves

    sig = _frame_signal()
    cfg = BpskConfig(rate=96000, fuse_mf=True)
    tunings = [12000.0, 6000.0]
    meta = {"rate": 96000, "n_demods": 2}

    def run(blocks, resume=False, save=False):
        stage = TelemetryStage(cfg, tunings, sync_every=2, device="cpu")
        s = Session(source=iter([blocks]), block_samples=96000,
                    checkpoint_path=tmp_path / "ck.npz",
                    checkpoint_meta=meta, device="cpu")
        if resume:
            s.load_checkpoint([stage])
        frames = _listen(s, "telemetry-frame")["telemetry-frame"]
        s.run([stage])
        if save:
            s.save_checkpoint([stage])
        return stage.state, [(f["demod"], f["ok"], f["payload"].tobytes())
                             for f in frames]

    whole, frames = run(sig)
    k = 3 * 96000
    _, first = run(sig[:k], save=True)
    resumed, second = run(sig[k:], resume=True)
    assert first + second == frames and len(frames) >= 1
    for a, b in zip(tree_leaves(resumed), tree_leaves(whole)):
        assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _auto_tune_chunks():
    """Raw int16 chunks of one noisy stream carrying two frames, one in
    each half-band of the auto-tuner's search (11.9 and 30 kHz), and the
    payloads."""
    rng = np.random.default_rng(19)
    pay = rng.integers(0, 256, (2, 256), dtype=np.uint8)
    sig = sum(sources.synth_bpsk_stream(pay[i:i + 1], rate=96000,
                                        carrier_offset=c, preamble_bits=400,
                                        amplitude=0.4, noise_rms=0.15,
                                        seed=i)
              for i, c in enumerate((11900.0, 30000.0)))
    sig = np.concatenate([sig, np.zeros((-len(sig)) % 96000, np.complex64)])
    raw = np.frombuffer(j_convert.complex_to_s16le(sig), "<i2")
    return [raw[i:i + 64000] for i in range(0, len(raw), 64000)], pay


# per instance: (tuning, dofft, track_high): the lower and upper half-band
# auto-tuners and a manual instance in the general mode (mixed:general)
AUTO_INSTANCES = ((0.0, True, False), (0.0, True, True), (11900.0, False,
                                                         False))


def test_telemetry_stage_auto_tune_matches_the_jax_session():
    """TelemetryStage(dofft=..., track_high=...) forwards both flags per
    instance: the same frames (instance, corr, ok, errors, payload) and
    counters as the JAX Session's stage, each frame decoded by the
    instance whose half-band holds it, and the same tuner centre bins."""
    from jsdr_tpu.demod.bpsk import BpskConfig as JConfig
    from jsdr_tpu.runtime.executor import Session as JSession
    from jsdr_tpu.runtime.executor import TelemetryStage as JTelemetryStage

    chunks, pay = _auto_tune_chunks()
    tun, dofft, high = (list(v) for v in zip(*AUTO_INSTANCES))
    got, stages = [], []
    for cls, stage_cls, cfg, kw in (
            (Session, TelemetryStage, BpskConfig(rate=96000),
             {"device": "cpu"}),
            (JSession, JTelemetryStage, JConfig(rate=96000), {})):
        s = cls(source=iter(chunks), block_samples=96000, **kw)
        got.append(_listen(s, "telemetry-frame", "telemetry-counters"))
        stages.append(stage_cls(cfg, tun, dofft=dofft, track_high=high,
                                sync_every=2, **kw))
        s.run([stages[-1]])
        assert s.dropped_blocks == {}
    port, ref = got
    assert port["telemetry-counters"] == ref["telemetry-counters"]
    assert len(port["telemetry-frame"]) == len(ref["telemetry-frame"])
    for p, r in zip(port["telemetry-frame"], ref["telemetry-frame"]):
        assert {k: v for k, v in p.items() if k != "payload"} == {
            k: v for k, v in r.items() if k != "payload"}
        assert np.array_equal(p["payload"], r["payload"])
    ok = sorted((f["demod"], f["payload"].tobytes())
                for f in port["telemetry-frame"] if f["ok"])
    assert ok == [(0, pay[0].tobytes()), (1, pay[1].tobytes()),
                  (2, pay[0].tobytes())]
    np.testing.assert_array_equal(
        stages[0].state.fft_tuner.centre_bin.numpy(),
        np.asarray(stages[1].state.fft_tuner.centre_bin))
    assert stages[0].state.fft_tuner.centre_bin[2] == 0     # manual


def test_checkpoint_mid_auto_tune_resumes_in_either_package(tmp_path):
    """A checkpoint written after 2 blocks of the auto-tune instances and
    loaded by a new Session ends with the frames and state of an
    uninterrupted run (bit for bit); the JAX package loads the same file
    into its state, leaf for leaf, and the port loads the JAX Session's
    checkpoint at that point with equal decisions and tuner state."""
    import jax
    from jsdr_tpu.demod.bpsk import BpskConfig as JConfig
    from jsdr_tpu.demod.bpsk import bpsk_init_batch as j_init
    from jsdr_tpu.runtime.executor import Session as JSession
    from jsdr_tpu.runtime.executor import TelemetryStage as JTelemetryStage
    from jsdr_tpu.runtime.state import load_state as j_load
    from jsdr_tpu_torch.runtime.state import load_state, tree_leaves

    chunks, _pay = _auto_tune_chunks()
    raw = np.concatenate(chunks)
    tun, dofft, high = (list(v) for v in zip(*AUTO_INSTANCES))
    cfg = BpskConfig(rate=96000, fuse_mf=True)
    meta = {"rate": 96000, "n_demods": len(tun)}

    def run(data, path, resume=False, save=False):
        stage = TelemetryStage(cfg, tun, dofft=dofft, track_high=high,
                               sync_every=2, device="cpu")
        s = Session(source=iter([data]), block_samples=96000,
                    checkpoint_path=path, checkpoint_meta=meta,
                    device="cpu")
        if resume:
            s.load_checkpoint([stage])
        frames = _listen(s, "telemetry-frame")["telemetry-frame"]
        s.run([stage])
        if save:
            s.save_checkpoint([stage])
        return stage.state, [(f["demod"], f["ok"], f["payload"].tobytes())
                             for f in frames]

    k = 2 * 96000 * 2                       # int16 values of 2 blocks
    ck = tmp_path / "ck.npz"
    whole, frames = run(raw, tmp_path / "unused.npz")
    mid, first = run(raw[:k], ck, save=True)
    resumed, second = run(raw[k:], ck, resume=True)
    assert first + second == frames and len(frames) >= 2
    for a, b in zip(tree_leaves(resumed), tree_leaves(whole)):
        assert torch.equal(a, b)

    j_like = {"telemetry": j_init(JConfig(rate=96000), len(tun))}
    j_state = j_load(ck, j_like, expect_meta=meta)["telemetry"]
    for a, b in zip(jax.tree.leaves(j_state), tree_leaves(mid)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    jstage = JTelemetryStage(JConfig(rate=96000, fuse_mf=True), tun,
                             dofft=dofft, track_high=high, sync_every=2)
    js = JSession(source=iter([raw[:k]]), block_samples=96000,
                  checkpoint_path=tmp_path / "jax.npz", checkpoint_meta=meta)
    js.run([jstage])
    js.save_checkpoint([jstage])
    like = {"telemetry": TelemetryStage(cfg, tun, device="cpu").state}
    got = load_state(tmp_path / "jax.npz", like, expect_meta=meta)
    got = got["telemetry"]
    for name in ("counters", "ring", "vco_idx", "tu_phase"):
        assert torch.equal(getattr(got, name), getattr(mid, name)), name
    for a, b in zip(got.fft_tuner[1:], mid.fft_tuner[1:]):
        assert torch.equal(a, b)


class _ListSink:
    """An ``io.live.AudioSink`` stand-in that keeps what it is given."""

    def __init__(self):
        self.blocks = []

    def write(self, audio):
        self.blocks.append(audio)

    def close(self):
        pass


def _demod_chunks(n_blocks=5, block=9600, seed=12):
    rng = np.random.default_rng(seed)
    iq = (0.3 * (rng.standard_normal(n_blocks * block)
                 + 1j * rng.standard_normal(n_blocks * block))
          ).astype(np.complex64)
    return np.split(iq, n_blocks)


def _demod_cfg():
    from jsdr_tpu_torch.demod.am_fm import AmFmConfig, Mode
    return AmFmConfig(rate=96000, mode=int(Mode.WFM), dofir=True,
                      dodwn=True, doagc=True, flo=-7333, fhi=9000)


def test_demod_stage_feeds_the_sink_and_skips_a_dropped_block():
    """``DemodStage`` publishes host float audio on 'audio-out' every
    block and ``AudioSinkStage`` writes it; a block the demod stage drops
    (failed twice) is not replayed from the previous block's audio."""
    class Flaky(DemodStage):
        calls = 0

        def process(self, block, session):
            Flaky.calls += 1
            if Flaky.calls in (3, 4):          # block 2: first try + retry
                raise RuntimeError("transient")
            super().process(block, session)

    sink = _ListSink()
    stages = [Flaky(_demod_cfg(), device="cpu"), AudioSinkStage(sink)]
    s = Session(source=iter(_demod_chunks()), block_samples=9600,
                device="cpu")
    assert s.run(stages) == 5
    assert s.dropped_blocks == {"demod": 1}
    assert len(sink.blocks) == 4
    assert all(isinstance(b, np.ndarray) and b.dtype == np.float32
               and b.shape == (9600,) for b in sink.blocks)


def test_demod_stage_checkpoints_resume_in_either_package(tmp_path):
    """A ``DemodStage`` checkpoint written after 2 of 5 blocks by either
    package loads in the other, which resumes to the audio of an
    uninterrupted run (within the demodulator's tolerance, 2e-5 after AGC;
    the FIR tail bit-equal)."""
    from jsdr_tpu.demod.am_fm import AmFmConfig as JConfig
    from jsdr_tpu.runtime.executor import DemodStage as JDemodStage
    from jsdr_tpu.runtime.executor import Session as JSession

    chunks = _demod_chunks()
    meta = {"rate": 96000}

    def run(package, data, path, resume=False, save=False):
        if package == "port":
            stage = DemodStage(_demod_cfg(), device="cpu")
            s = Session(source=iter(data), block_samples=9600,
                        checkpoint_path=path, checkpoint_meta=meta,
                        device="cpu")
        else:
            stage = JDemodStage(JConfig(*_demod_cfg()))
            s = JSession(source=iter(data), block_samples=9600,
                         checkpoint_path=path, checkpoint_meta=meta)
        if resume:
            s.load_checkpoint([stage])
        audio = _listen(s, "audio-out")["audio-out"]
        s.run([stage])
        if save:
            s.save_checkpoint([stage])
        return audio, stage.state

    whole, _ = run("jax", chunks, tmp_path / "unused.npz")
    for writer, reader in (("port", "jax"), ("jax", "port")):
        ck = tmp_path / f"{writer}.npz"
        first, _ = run(writer, chunks[:2], ck, save=True)
        second, state = run(reader, chunks[2:], ck, resume=True)
        got = first + second
        assert len(got) == len(whole) == 5
        for a, b in zip(got, whole):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=0, atol=2e-5)
    tail = np.concatenate(chunks[:5])[-20:]
    np.testing.assert_array_equal(state.fir_tail.re.numpy(), tail.real)
