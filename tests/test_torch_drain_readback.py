"""The telemetry drain's read-back (``runtime/executor.py::TelemetryStage.
_drain``) against the loop it replaced, kept here as the plain reference:
a masked read of each pending block's windows, corrs and hit indices,
then ``.cpu()`` of the counters, the decode's results and, in a
``SpectrumTelemetryStage``, the lines and the peak, each a wait for the
card. Both drains take the same pending outputs of seeded frame trains on
two tabs (hits in several blocks and on both instances) and must publish
the same stream: topics, order, values and bytes, through drains without
hits, a partial last drain from ``finish()``, a mesh whose padding
instance has hits of its own, and the spectrum stage's lines and peak.
The drain waits on the card once, and once more only where it decodes
(``drain.waits``); it decodes the hit windows alone, and the arrays it
publishes are its own."""

import functools
from collections import Counter

import numpy as np
import pytest
import torch

from jsdr_tpu_torch.demod.bpsk import BpskConfig
from jsdr_tpu_torch.fec import decoder
from jsdr_tpu_torch.io import sources
from jsdr_tpu_torch.ops.cplx import CF
from jsdr_tpu_torch.ops.spectrum_fused import waterfall_natural_order
from jsdr_tpu_torch.runtime import executor
from jsdr_tpu_torch.runtime.executor import (Session, SpectrumTelemetryStage,
                                             TelemetryStage)

RATE = 96000
TABS = (12000.0, 24000.0)
BLOCKS = 14


@functools.lru_cache(maxsize=None)
def _station(n: int) -> np.ndarray:
    """Frame trains on both tabs' carriers in noise, ``n`` samples at 96
    kS/s: a frame (~4.33 s) every 4.4 s or so on each tab, the second
    tab's 0.75 s later."""
    rng = np.random.default_rng(26)
    sig = sources.synth_noise(n, amplitude=0.05, seed=26)
    for i, carrier in enumerate(TABS):
        pay = rng.integers(0, 256, (4, 256), dtype=np.uint8)
        tab = sources.synth_bpsk_stream(
            pay, rate=RATE, carrier_offset=carrier, amplitude=0.3,
            preamble_bits=300 + 900 * i, seed=26 + i)[:n]
        sig[:len(tab)] += tab
    return sig


def _block(sig: np.ndarray, b: int, size: int) -> CF:
    x = sig[b * size:(b + 1) * size]
    return CF(torch.as_tensor(x.real.copy()), torch.as_tensor(x.imag.copy()))


def _reference_drain(stage, session):
    """The drain as it was: lines and peak, counters, then a masked read
    of each pending block's hits, one batched decode, and ``.cpu()`` of
    its results."""
    from jsdr_tpu_torch.fec.decoder import fec_decode
    spec = getattr(stage, "_spec", None)
    if spec is not None:
        stage._spec = None
        lines = waterfall_natural_order(spec.wf)[0].cpu().numpy()
        peak = (int(spec.peak_freq[0, -1]), float(spec.peak_db[0, -1]))
        session.publish("waterfall-line", lines)
        session.publish("fft-peak", peak)
    pending, stage._pending = stage._pending, []
    if not pending:
        return
    tunings = stage.tunings or [stage.cfg.tuning]
    c = stage.state.counters.cpu().numpy()
    session.publish(
        "telemetry-counters",
        {s: tuple(int(v) for v in c[s]) for s in range(stage.n_real)})
    for s in range(stage.n_real):
        session.publish(f"FUNcube{s}-bpsk-tune", tunings[s])
    where, windows, corrs = [], [], []
    for out in pending:
        dev = out.n_hits.device
        hit = ((torch.arange(out.windows.shape[1], device=dev)[None, :]
                < out.n_hits[:, None])
               & (torch.arange(out.n_hits.shape[0], device=dev)
                  < stage.n_real)[:, None])
        windows.append(out.windows[hit])
        corrs.append(out.hit_corr[hit])
        where.append(torch.nonzero(hit)[:, 0])
    windows = torch.cat(windows)
    if not len(windows):
        return
    res = fec_decode(windows)
    demod = torch.cat(where).cpu().numpy()
    corr = torch.cat(corrs).cpu().numpy()
    ok, rc = res.ok.cpu().numpy(), res.rc.cpu().numpy()
    payload = res.payload.cpu().numpy()
    for j, s in enumerate(demod):
        session.publish("telemetry-frame", {
            "demod": int(s), "tuning": tunings[s], "ok": bool(ok[j]),
            "corr": int(corr[j]), "channel_errors": int(rc[j]),
            "payload": payload[j]})


class _Reference:
    def _drain(self, session):
        _reference_drain(self, session)


class _RefTelemetry(_Reference, TelemetryStage):
    pass


class _RefSpectrumTelemetry(_Reference, SpectrumTelemetryStage):
    pass


def _plain(v):
    """A published value as nested plain data: arrays by dtype, shape and
    bytes, scalars with their type."""
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, tuple):
        return tuple(_plain(x) for x in v)
    return (type(v).__name__, v)


def _session():
    s = Session(source=iter(()), block_samples=RATE, device="cpu")
    got = []
    s.pubsub.listen(lambda t, v: got.append((t, v)))
    return s, got


@functools.lru_cache(maxsize=None)
def _outputs(cls, mesh: bool = False):
    """The stage after BLOCKS blocks of the station without a drain, and
    each block's (pending output, shown waterfall, state after it)."""
    cfg = BpskConfig(rate=RATE)
    if mesh:
        from jsdr_tpu_torch.parallel import make_mesh
        stage = cls(cfg, TABS + (12000.0,), sync_every=1 << 20,
                    mesh=make_mesh(dp=2, sp=4, device="cpu"), device="cpu")
        size = TelemetryStage.block_samples_for(cfg, stage.mesh)
    else:
        stage = cls(cfg, TABS, sync_every=1 << 20, device="cpu")
        size = RATE
    sig = _station(BLOCKS * size)
    session, _ = _session()
    per_block = []
    for b in range(BLOCKS):
        stage.process(_block(sig, b, size), session)
        per_block.append((stage._pending[-1], getattr(stage, "_spec", None),
                          stage.state))
    return stage, per_block


def _drain_of(stage, per_block, first, last, drain):
    """Publish the drain of blocks [first, last) with ``drain``; returns
    the published (topic, value) stream and the drain's counters (0
    where a counter was not counted)."""
    stage._pending = [out for out, _, _ in per_block[first:last]]
    stage._spec = per_block[last - 1][1]
    stage.state = per_block[last - 1][2]
    session, got = _session()
    drain(stage, session)
    return got, Counter(session.tracer.counters)


def _frames(stream):
    return [v for t, v in stream if t == "telemetry-frame"]


def _groups(n=BLOCKS, every=4):
    return [(b, min(b + every, n)) for b in range(0, n, every)]


@pytest.fixture
def waits(monkeypatch):
    """The drain's host waits on the card, counted by a wrapper of the
    one function that waits."""
    calls = []
    wait = executor._wait

    def counted(device, tr):
        calls.append(device)
        wait(device, tr)

    monkeypatch.setattr(executor, "_wait", counted)
    return calls


@pytest.fixture
def decodes(monkeypatch):
    """The windows each ``fec_decode`` call got."""
    calls = []
    decode = decoder.fec_decode

    def counted(raw):
        calls.append(raw.clone())
        return decode(raw)

    monkeypatch.setattr(decoder, "fec_decode", counted)
    return calls


@pytest.mark.parametrize("cls", [TelemetryStage, SpectrumTelemetryStage])
def test_each_drain_publishes_what_the_masked_reads_published(cls, waits,
                                                              decodes):
    """Every group of 4 blocks, and the 2 after them: the same stream as
    the reference, at most two waits (exactly one without a hit), and the
    decode given the hit windows alone, in (block, instance, hit)
    order."""
    stage, per_block = _outputs(cls)
    demods, hit_drains, good = set(), 0, 0
    for first, last in _groups():
        n0 = len(decodes)
        ref, _ = _drain_of(stage, per_block, first, last, _reference_drain)
        n1 = len(decodes)
        waits.clear()
        got, counters = _drain_of(stage, per_block, first, last,
                                  cls._drain)
        assert [_plain(v) for v in got] == [_plain(v) for v in ref]
        assert [t for t, _ in got][:2] == (
            ["waterfall-line", "fft-peak"] if cls is SpectrumTelemetryStage
            else ["telemetry-counters", "FUNcube0-bpsk-tune"])
        frames = _frames(got)
        assert counters["drain.runs"] == 1
        assert counters["drain.hits"] == len(frames)
        assert counters["drain.good"] == sum(f["ok"] for f in frames)
        assert counters["drain.failed"] == len(frames) - counters["drain.good"]
        assert len(waits) == counters["drain.waits"] == 1 + bool(frames)
        mine = decodes[n1:]
        if frames:
            hit_drains += 1
            demods |= {f["demod"] for f in frames}
            good += counters["drain.good"]
            (raw,) = mine
            assert torch.equal(raw, decodes[n0])
            assert raw.shape == (len(frames), 5200)
        else:
            assert mine == []
    # the data holds what the cases need
    assert hit_drains >= 2 and demods == {0, 1} and good >= 2


def test_a_drain_without_hits_waits_once_and_decodes_nothing(waits,
                                                             decodes):
    stage, per_block = _outputs(TelemetryStage)
    empty = [(b, b + 1) for b in range(BLOCKS)
             if not _frames(_drain_of(stage, per_block, b, b + 1,
                                      _reference_drain)[0])]
    assert len(empty) >= 2
    for first, last in empty:
        waits.clear()
        del decodes[:]
        got, counters = _drain_of(stage, per_block, first, last,
                                  TelemetryStage._drain)
        assert decodes == []                 # no kernel A, no kernel B
        assert len(waits) == counters["drain.waits"] == 1
        assert counters["drain.hits"] == 0
        ref, _ = _drain_of(stage, per_block, first, last, _reference_drain)
        assert [_plain(v) for v in got] == [_plain(v) for v in ref]


def test_an_empty_drain_publishes_nothing(waits):
    stage = TelemetryStage(BpskConfig(rate=RATE), TABS, device="cpu")
    session, got = _session()
    stage.finish(session)
    assert got == [] and waits == []
    assert "drain.runs" not in session.tracer.counters


@pytest.mark.parametrize("cls,ref", [
    (TelemetryStage, _RefTelemetry),
    (SpectrumTelemetryStage, _RefSpectrumTelemetry)])
def test_a_session_ends_with_a_partial_drain_as_before(cls, ref, waits):
    """A Session of 6 blocks with ``sync_every`` 4: one full drain, then
    ``finish()`` drains the last 2; the whole published stream (every
    topic, the Session's own too) equals the reference stage's."""
    streams, counters = [], []
    for c in (cls, ref):
        sig = _station(6 * RATE)
        s = Session(source=iter([sig]), block_samples=RATE, device="cpu")
        got = []
        s.pubsub.listen(lambda t, v: got.append((t, v)))
        assert s.run([c(BpskConfig(rate=RATE), TABS, device="cpu")]) == 6
        streams.append([_plain(v) for v in got])
        counters.append(dict(s.tracer.counters))
    assert streams[0] == streams[1]
    assert counters[0]["drain.runs"] == 2
    assert len(waits) == counters[0]["drain.waits"] <= 4


def test_padding_instances_publish_nothing(waits):
    """A mesh of dp 2 pads three tabs to four with a copy of the last,
    which finds the same frames: the drain publishes the three real ones
    alone, as the reference did."""
    stage, per_block = _outputs(TelemetryStage, mesh=True)
    assert stage.n == 4 and stage.n_real == 3
    padded = 0
    for first, last in _groups():
        padded += sum(int(out.n_hits[3]) for out, _, _ in
                      per_block[first:last])
        ref, _ = _drain_of(stage, per_block, first, last, _reference_drain)
        got, counters = _drain_of(stage, per_block, first, last,
                                  TelemetryStage._drain)
        assert [_plain(v) for v in got] == [_plain(v) for v in ref]
        assert {f["demod"] for f in _frames(got)} <= {0, 1, 2}
        assert set(dict(got)["telemetry-counters"]) == {0, 1, 2}
        assert counters["drain.waits"] == 1 + bool(_frames(got))
    assert padded > 0


def test_lines_and_peak_are_the_spectrum_stage_s_own():
    """``SpectrumTelemetryStage``'s drain publishes stream 0's lines and
    last peak byte for byte as the reference's ``.cpu()`` read them."""
    stage, per_block = _outputs(SpectrumTelemetryStage)
    for first, last in _groups():
        got, _ = _drain_of(stage, per_block, first, last,
                           SpectrumTelemetryStage._drain)
        (lines,) = [v for t, v in got if t == "waterfall-line"]
        (peak,) = [v for t, v in got if t == "fft-peak"]
        spec = per_block[last - 1][1]
        want = waterfall_natural_order(spec.wf)[0].numpy()
        assert lines.dtype == want.dtype and lines.shape == want.shape
        assert lines.tobytes() == want.tobytes() and lines.flags.c_contiguous
        assert type(peak[0]) is int and type(peak[1]) is float
        assert peak == (int(spec.peak_freq[0, -1]),
                        float(spec.peak_db[0, -1]))


def test_published_arrays_of_two_drains_do_not_alias():
    """Each drain's frames and lines are arrays of their own: a later
    drain's host block neither shares their memory nor changes them."""
    stage, per_block = _outputs(SpectrumTelemetryStage)
    hit = [g for g in _groups()
           if _frames(_drain_of(stage, per_block, *g, _reference_drain)[0])]
    assert len(hit) >= 2
    kept = []
    for g in hit:
        got, _ = _drain_of(stage, per_block, *g,
                           SpectrumTelemetryStage._drain)
        arrays = [v["payload"] for v in _frames(got)]
        arrays += [v for t, v in got if t == "waterfall-line"]
        kept.append([(a, a.tobytes()) for a in arrays])
    for i, early in enumerate(kept):
        for a, before in early:
            assert a.tobytes() == before
            for later in kept[i + 1:]:
                assert not any(np.shares_memory(a, b) for b, _ in later)
