"""The port's tracer (``runtime/log.py::StageTimers``) inside its Session
(``runtime/executor.py``), on the CPU: the one-frame Session of
tests/test_torch_runtime.py with spans on gives each block's spans their
names, parents and block index, its top-level spans cover the block's
wall, and the counters count blocks and the drain's hits; a caller's own
``timers`` gets the same stage calls as before the tracer existed; with
spans off nothing is stored and no profiler range opens; under torch's
profiler the ``jsdr.*`` ranges sit inside the caller's ranges and the
``jsdr.clock`` reading maps the spans onto the trace's clock; the ring
keeps its size; ``telemetry --trace-out`` writes the spans and counters
and prints the drain's counters. In the written trace a
``SpectrumTelemetryStage`` opens ``spectrum_telemetry.step`` (not
``telemetry.step``) and counts ``spectrum_telemetry.merged`` or
``.staged`` once a block, a ``TelemetryStage`` still opens
``telemetry.step``, and ``session.framer_bytes`` counts each block's bytes
once, the raw and the complex framer's, on whole and ragged chunks. Both
telemetry stages count the front end each step ran,
``telemetry.front.<mode>``, deciding the mode once a tuning set."""

import functools
import json
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from jsdr_tpu_torch.demod.bpsk import BpskConfig
from jsdr_tpu_torch.io import sources
from jsdr_tpu_torch.io.convert import complex_to_s16le
from jsdr_tpu_torch.runtime import log
from jsdr_tpu_torch.runtime.executor import (Session, SpectrumStage,
                                             SpectrumTelemetryStage,
                                             TelemetryStage)
from jsdr_tpu_torch.runtime.log import StageTimers


@functools.lru_cache(maxsize=None)
def _frame_signal() -> np.ndarray:
    """One AO-40 frame (payload 0..255) at 12 kHz, padded to whole 1 s
    blocks at 96 kS/s (tests/test_torch_runtime.py's signal)."""
    payload = np.arange(256, dtype=np.uint8)[None]
    sig = sources.synth_bpsk_stream(payload, rate=96000, preamble_bits=300)
    return np.concatenate([sig, np.zeros((-len(sig)) % 96000, np.complex64)])


def _chunks():
    sig = _frame_signal()
    return (sig[i:i + 48000] for i in range(0, len(sig), 48000))


def _stages():
    return [SpectrumStage(96000),
            TelemetryStage(BpskConfig(rate=96000, tuning=12000.0),
                           device="cpu")]


class _StageOnly:
    """A caller's timers with ``stage()`` alone (the benchmark's kind),
    recording each call; with ``annotate`` a profiler range
    ``pb.stage.<name>`` around it."""

    def __init__(self, annotate: bool = False):
        self.calls = []
        self.annotate = annotate

    @contextmanager
    def stage(self, name, samples=0):
        self.calls.append((name, samples))
        if self.annotate:
            with torch.profiler.record_function(f"pb.stage.{name}"):
                yield
        else:
            yield


@pytest.fixture(scope="module")
def traced():
    """The one-frame Session with spans on and a caller's timers."""
    timers = _StageOnly()
    s = Session(source=_chunks(), block_samples=96000, device="cpu",
                timers=timers)
    s.tracer.spans_on = True
    frames = []
    s.pubsub.listen(lambda t, v: frames.append(v)
                    if t == "telemetry-frame" else None)
    n = s.run(_stages())
    return s, timers, n, frames


def test_spans_have_names_parents_and_blocks(traced):
    s, _, n, frames = traced
    assert n == len(_frame_signal()) // 96000 and len(frames) == 1
    spans = s.tracer.spans()
    for b in range(n):
        top = [name for name, blk, parent, *_ in spans
               if blk == b and parent is None]
        assert top == ["session.frame", "h2d", "spectrum", "telemetry",
                       "publish:audio-frame"], (b, top)
        kids = {(name, parent) for name, blk, parent, *_ in spans
                if blk == b and parent is not None}
        want = {("spectrum.readback", "spectrum"),
                ("publish:fft-psd", "spectrum"),
                ("publish:fft-peak", "spectrum"),
                ("telemetry.step", "telemetry")}
        if (b + 1) % 4 == 0:
            want |= {("telemetry.drain", "telemetry"),
                     ("drain.readback", "telemetry.drain"),
                     ("publish:telemetry-counters", "telemetry.drain"),
                     ("publish:FUNcube0-bpsk-tune", "telemetry.drain")}
        assert want <= kids, (b, want - kids)
    # the final flush, after the last block, carries block n
    after = {(name, parent) for name, blk, parent, *_ in spans if blk == n}
    assert ("telemetry.drain", None) in after
    assert ("session.frame", None) in after
    # the frame's drain decoded it: the FEC kernels' enqueue and the
    # frame's publish sit inside a drain
    fec = [(blk, parent) for name, blk, parent, *_ in spans
           if name in ("drain.fec", "publish:telemetry-frame")]
    assert len(fec) == 2 and all(p == "telemetry.drain" for _, p in fec)
    assert all(t1 >= t0 for *_, t0, t1 in spans)


def test_top_level_spans_cover_each_block(traced):
    s, _, n, _ = traced
    spans = s.tracer.spans()
    start = {blk: t0 for name, blk, _, t0, _ in spans
             if name == "session.frame"}
    end_of = {blk: t1 for name, blk, _, _, t1 in spans
              if name == "publish:audio-frame"}
    for b in range(n):
        wall = (start[b + 1] if b + 1 < n else end_of[b]) - start[b]
        top = sum(t1 - t0 for _, blk, parent, t0, t1 in spans
                  if blk == b and parent is None)
        assert top <= wall and top >= 0.95 * wall, (b, top / wall)


def test_counters_count_blocks_and_the_drain(traced):
    s, _, n, _ = traced
    c = s.tracer.counters
    assert c["session.blocks"] == n and c["session.retries"] == 0
    assert c["drain.good"] == 1 and c["drain.hits"] >= 1
    assert c["drain.failed"] == c["drain.hits"] - 1
    assert c["drain.runs"] == -(-n // 4)


def test_a_callers_timers_get_the_stage_calls_alone(traced):
    """The calls a caller's ``timers`` got before the tracer existed:
    "h2d" with the block's samples, then each stage's name with the
    block's length, once a block, in order; the tracer sums the same."""
    s, timers, n, _ = traced
    assert timers.calls == [("h2d", 96000), ("spectrum", 96000),
                            ("telemetry", 96000)] * n
    assert s.timers is timers and s.tracer is not timers
    rep = s.tracer.report()
    assert list(rep) == ["h2d", "spectrum", "telemetry"]
    assert all(r["calls"] == n and r["samples"] == n * 96000
               for r in rep.values())


@pytest.mark.parametrize("spans", [False, True])
def test_no_profiler_range_opens_while_no_profiler_records(monkeypatch,
                                                           spans):
    def refuse(*a, **k):
        raise AssertionError("record_function opened without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    sig = sources.synth_noise(4 * 9600, seed=0)
    s = Session(source=iter([sig]), block_samples=9600, device="cpu",
                timers=StageTimers(spans=spans) if spans else None)
    assert s.timers is s.tracer
    assert s.run([SpectrumStage(9600)]) == 4
    assert log.latest() is s.tracer
    assert s.tracer.counters["session.blocks"] == 4
    assert s.tracer.report()["spectrum"]["calls"] == 4
    assert (len(s.tracer.spans()) > 0) == spans
    assert s.tracer.clock_ns is None
    if not spans:
        assert s.tracer.span("x") is s.tracer.span("y")


def test_profiled_ranges_nest_and_map_onto_the_trace(tmp_path):
    """A run that starts under the profiler turns spans on to its end;
    each ``jsdr.<stage>`` range lies inside the caller's
    ``pb.stage.<stage>``, and ``clock_ns`` maps every span onto its range
    to within 1 ms."""
    from torch.profiler import ProfilerActivity, profile

    timers = _StageOnly(annotate=True)
    stages = _stages()
    stages[1].sync_every = 1
    s = Session(source=_chunks(), block_samples=96000, device="cpu",
                timers=timers)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        n = s.run(stages, max_blocks=2)
    assert not s.tracer.spans_on and s.tracer.clock_ns is not None
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"
              and e["name"].startswith(("jsdr.", "pb.stage."))]
    clock = [e for e in events if e["name"] == "jsdr.clock"]
    assert len(clock) == 1
    names = {e["name"] for e in events}
    assert {"jsdr.session.frame", "jsdr.h2d", "jsdr.spectrum",
            "jsdr.spectrum.readback", "jsdr.telemetry.step",
            "jsdr.telemetry.drain", "jsdr.drain.readback",
            "jsdr.publish:audio-frame"} <= names
    for stage in ("h2d", "spectrum", "telemetry"):
        inner = sorted((e for e in events if e["name"] == f"jsdr.{stage}"),
                       key=lambda e: e["ts"])
        outer = sorted((e for e in events
                        if e["name"] == f"pb.stage.{stage}"),
                       key=lambda e: e["ts"])
        assert len(inner) == len(outer) == n
        for i, o in zip(inner, outer):
            assert o["ts"] <= i["ts"]
            assert i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    # the in-memory spans on the trace's clock, name by name in order
    ts0 = clock[0]["ts"]
    spans = s.tracer.spans()
    for name in {sp[0] for sp in spans}:
        mine = [(t0 - s.tracer.clock_ns) / 1e3 + ts0
                for nm, _, _, t0, _ in spans if nm == name]
        theirs = sorted(e["ts"] for e in events
                        if e["name"] == f"jsdr.{name}")
        assert len(mine) == len(theirs), name
        assert max(abs(a - b) for a, b in zip(mine, theirs)) < 1e3, name


def test_ring_keeps_its_size(monkeypatch):
    monkeypatch.setattr(StageTimers, "RING", 8)
    tr = StageTimers(spans=True)
    for b in range(5):
        tr.begin_block(b)
        for i in range(4):
            with tr.span(f"s{i}"):
                pass
    spans = tr.spans()
    assert len(spans) == 8 and len(tr._ring) == 8
    assert [(name, blk) for name, blk, *_ in spans] == [
        (f"s{i}", b) for b in (3, 4) for i in range(4)]
    assert [t0 for *_, t0, _ in spans] == sorted(t0 for *_, t0, _ in spans)


def test_cli_trace_out_writes_spans_and_counters(tmp_path, capsys):
    from jsdr_tpu_torch.app.main import main

    path, out = tmp_path / "frame.raw", tmp_path / "trace.json"
    path.write_bytes(complex_to_s16le(_frame_signal()))
    assert main(["telemetry", f"file:{path}", "--trace-out", str(out),
                 "--device", "cpu"]) == 0
    n = len(_frame_signal()) // 96000
    assert capsys.readouterr().out.strip().endswith(
        f"{n} blocks streamed, frames=1, dropped=none, hits=1, good=1, "
        f"failed=0, graph replays/captures/eager=0/0/{n}, "
        f"front pattern={n}")
    trace = json.loads(out.read_text())
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert {"session.frame", "h2d", "telemetry", "telemetry.step",
            "telemetry.drain", "drain.fec",
            "publish:telemetry-frame"} <= {e["name"] for e in spans}
    assert {e["args"]["block"] for e in spans} == set(range(n + 1))
    counters = trace["otherData"]["counters"]
    assert counters["session.blocks"] == n and counters["drain.good"] == 1
    assert counters["telemetry.front.pattern"] == n
    assert [e["args"] for e in trace["traceEvents"]
            if e["ph"] == "C"] == [counters]


def _written(tracer, path):
    """The trace ``--trace-out`` writes: (spans as (name, block, parent),
    counters)."""
    tracer.write_chrome_trace(path)
    trace = json.loads(path.read_text())
    spans = [(e["name"], e["args"]["block"], e["args"]["parent"])
             for e in trace["traceEvents"] if e["ph"] == "X"]
    return spans, trace["otherData"]["counters"]


def _raw_chunks(blocks: int, block: int, chunk: int, seed: int = 17):
    raw = np.random.default_rng(seed).integers(
        -3000, 3000, 2 * block * blocks, dtype=np.int16)
    return [raw[i:i + 2 * chunk] for i in range(0, len(raw), 2 * chunk)]


@pytest.mark.parametrize("block,ran", [(38400, "merged"), (96000, "staged")])
def test_spectrum_telemetry_step_span_and_counters(tmp_path, block, ran):
    """At 96 kS/s a 0.4 s block is a whole number of the merged kernel's
    4-FFT-block chunks and runs it; a 1 s block is not and runs the staged
    pair. Either way the step's span is ``spectrum_telemetry.step``, once
    a block inside the stage's span, and ``telemetry.step`` never opens."""
    blocks = 3
    s = Session(source=iter(_raw_chunks(blocks, block, 9600)),
                block_samples=block, device="cpu",
                timers=StageTimers(spans=True))
    stage = SpectrumTelemetryStage(BpskConfig(rate=96000, tuning=12000.0),
                                   sync_every=2, device="cpu")
    assert s.run([stage]) == blocks
    spans, counters = _written(s.tracer, tmp_path / "trace.json")
    steps = [(b, parent) for name, b, parent in spans
             if name == "spectrum_telemetry.step"]
    assert steps == [(b, "spectrum-telemetry") for b in range(blocks)]
    assert not any(name == "telemetry.step" for name, *_ in spans)
    other = "staged" if ran == "merged" else "merged"
    assert counters[f"spectrum_telemetry.{ran}"] == blocks
    assert f"spectrum_telemetry.{other}" not in counters
    assert counters["telemetry.graph_eager"] == blocks
    assert counters["session.framer_bytes"] == blocks * block * 4


def test_telemetry_stage_keeps_its_step_span(traced, tmp_path):
    """The 96 kS/s stages open ``telemetry.step`` once a block, as before,
    and count no ``spectrum_telemetry`` step; their complex chunks are
    framed at 8 bytes a sample, each once."""
    s, _, n, _ = traced
    spans, counters = _written(s.tracer, tmp_path / "trace.json")
    steps = [(b, parent) for name, b, parent in spans
             if name == "telemetry.step"]
    assert steps == [(b, "telemetry") for b in range(n)]
    assert not any(name.startswith("spectrum_telemetry")
                   for name in [sp[0] for sp in spans] + list(counters))
    assert counters["session.framer_bytes"] == n * 96000 * 8


@pytest.mark.parametrize("tunings,mode", [((12730.0, 26230.0), "general"),
                                          ((12000.0, 25500.0), "pattern")])
@pytest.mark.parametrize("cls", [TelemetryStage, SpectrumTelemetryStage])
def test_front_end_counted_each_block_decided_once(monkeypatch, tmp_path,
                                                   cls, tunings, mode):
    """At 192 kS/s tabs off the 1500 Hz grid run the general front end and
    tabs on it the pattern front end (a ``SpectrumTelemetryStage``: the
    staged pair, the merged kernel): each block counts
    ``telemetry.front.<mode>`` once, and ``mix_mode_for`` decides the
    mode once for the tuning set, not once a block."""
    from jsdr_tpu_torch.demod import bpsk

    calls = []
    decide = bpsk.mix_mode_for

    def spy(*args):
        calls.append(args)
        return decide(*args)

    monkeypatch.setattr(bpsk, "mix_mode_for", spy)
    bpsk.front_mode.cache_clear()
    blocks, block = 3, 38400
    s = Session(source=iter(_raw_chunks(blocks, block, 19200)),
                block_samples=block, device="cpu",
                timers=StageTimers(spans=True))
    stage = cls(BpskConfig(rate=192000), tunings, sync_every=2,
                device="cpu")
    assert s.run([stage]) == blocks
    _, counters = _written(s.tracer, tmp_path / "trace.json")
    assert {k: v for k, v in counters.items()
            if k.startswith("telemetry.front.")} == {
        f"telemetry.front.{mode}": blocks}
    assert len(calls) == 1
    if cls is SpectrumTelemetryStage:
        ran = "merged" if mode == "pattern" else "staged"
        assert counters[f"spectrum_telemetry.{ran}"] == blocks


@pytest.mark.parametrize("chunk", [9600, 7001, 25000])
def test_framer_bytes_are_each_blocks_bytes(tmp_path, chunk):
    """Whole or ragged raw chunks: the framer copies each sample once, so
    the counter reads the raw blocks' bytes, 4 a sample; the samples of
    an unfinished last block are not counted."""
    block, blocks = 9600, 4
    chunks = _raw_chunks(blocks, block, chunk)
    chunks.append(np.zeros(2 * 100, np.int16))
    s = Session(source=iter(chunks), block_samples=block, device="cpu",
                timers=StageTimers(spans=True))
    assert s.run([SpectrumStage(9600)]) == blocks
    _, counters = _written(s.tracer, tmp_path / "trace.json")
    assert counters["session.blocks"] == blocks
    assert counters["session.framer_bytes"] == blocks * block * 4
