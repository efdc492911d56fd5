"""The stages' steps replayed from CUDA graphs
(``runtime/graph.py::GraphStep``, owned by ``TelemetryStage`` with
:func:`bpsk_block_batch`, by ``SpectrumTelemetryStage`` with
:func:`bpsk_block_batch_spectrum` and by ``SpectrumStage``'s waterfall
form with the stateless ``waterfall_step``) and the tables the step keeps
on its device.

On the CPU the stages run the eager step and count it; the tables equal
the module's and come back from a holder; the step's two state sets hand
out the right one; with a stub graph in CUDA's place, the key separates
the two step functions, a replay counts the launches of every
registered kernel wrapper, and ``SpectrumStage`` captures once, then
replays, each block read back into memory of its own. Tests marked ``card`` run the
graphed stages against the eager :func:`bpsk_block_batch` and
:func:`bpsk_block_batch_spectrum`, the graphed ``SpectrumStage``
against one with an eager step, kernel 3 at one FFT block a row
against the staged pair, and the graphed telemetry stages' drains
against the masked-read loop they replaced, on a card, bit for bit, and
skip without one:
``python -m pytest --noconftest -m card tests/test_torch_graph_step.py``
(this file imports no JAX, so it runs where the JAX package is absent)."""

import contextlib
import functools
import gc
import importlib
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jsdr_tpu_torch
from jsdr_tpu_torch.demod import am_fm
from jsdr_tpu_torch.demod import bpsk as B
from jsdr_tpu_torch.fec import _device as fec_tables
from jsdr_tpu_torch.fec.decoder import fec_check, fec_decode
from jsdr_tpu_torch.fec.encode import encode_fec40
from jsdr_tpu_torch.fec.rs import decode_rs
from jsdr_tpu_torch.fec.viterbi import viterbi27_bytes
from jsdr_tpu_torch.io import sources
from jsdr_tpu_torch.io.convert_device import s16_to_cf
from jsdr_tpu_torch.ops import _build
from jsdr_tpu_torch.ops.cplx import CF
from jsdr_tpu_torch.ops.mix_decimate import mix_decimate
from jsdr_tpu_torch.ops.mix_decimate_mf import mix_decimate_mf
from jsdr_tpu_torch.ops.psd_waterfall import psd_waterfall
from jsdr_tpu_torch.ops.spectrum_front import spectrum_front_fused
from jsdr_tpu_torch.ops.spectrum_fused import (_tables_on, spectrum_fused,
                                              spectrum_waterfall,
                                              waterfall_natural_order)
from jsdr_tpu_torch.ops.timing_kernel import timing_recover_batch
from jsdr_tpu_torch.runtime.device import holding
from jsdr_tpu_torch.ops import psd_waterfall as k5
from jsdr_tpu_torch.ops.mxu_fft import fft_cf
from jsdr_tpu_torch.ops.windows import hamming
from jsdr_tpu_torch.runtime.executor import (Session, SpectrumStage,
                                             SpectrumTelemetryStage,
                                             TelemetryStage)
from jsdr_tpu_torch.runtime.graph import GraphStep

RATE = 96000
TABS = (12000.0, 24000.0)


@functools.lru_cache(maxsize=None)
def _signal(blocks: int) -> np.ndarray:
    """Frame trains on both tabs' carriers in noise, ``blocks`` 1 s
    blocks at 96 kS/s."""
    rng = np.random.default_rng(18)
    n = blocks * RATE
    sig = sources.synth_noise(n, amplitude=0.05, seed=18)
    for i, carrier in enumerate(TABS):
        pay = rng.integers(0, 256, (3, 256), dtype=np.uint8)
        tab = sources.synth_bpsk_stream(
            pay, rate=RATE, carrier_offset=carrier, amplitude=0.3,
            preamble_bits=300 + 900 * i, seed=i)[:n]
        sig[:len(tab)] += tab
    return sig


@functools.lru_cache(maxsize=None)
def _station(rate: int, tabs: tuple, seconds: float) -> np.ndarray:
    """Frame trains on each tab's carrier in noise, ``seconds`` at
    ``rate``: a frame (~4.33 s) every 4.4 s or so on every tab."""
    rng = np.random.default_rng(20)
    n = int(seconds * rate)
    sig = sources.synth_noise(n, amplitude=0.05, seed=20)
    for i, carrier in enumerate(tabs):
        pay = rng.integers(0, 256, (int(seconds // 4.4) + 1, 256),
                           dtype=np.uint8)
        tab = sources.synth_bpsk_stream(
            pay, rate=rate, carrier_offset=carrier, amplitude=0.3,
            preamble_bits=300 + 900 * i, seed=i)[:n]
        sig[:len(tab)] += tab
    return sig


def _block(sig: np.ndarray, b: int, dev, size: int = RATE) -> CF:
    x = sig[b * size:(b + 1) * size]
    return CF(torch.as_tensor(x.real.copy(), device=dev),
              torch.as_tensor(x.imag.copy(), device=dev))


def _tabs(blk: CF, n: int = 2) -> CF:
    """One stream's block as ``n`` tabs' rows, as the stages feed them."""
    return CF(blk.re.expand(n, -1), blk.im.expand(n, -1))


def _equal(a, b) -> bool:
    """Two trees of tensors (outputs or states) equal bit for bit."""
    if isinstance(a, torch.Tensor):
        def bits(x):
            # flat: a contiguous tensor with a size-1 last dim may keep
            # another stride there, which a dtype view refuses
            x = x.contiguous().reshape(-1)
            return x.view(torch.uint8) if x.is_floating_point() else x
        return (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(bits(a), bits(b)))
    return all(_equal(x, y) for x, y in zip(a, b, strict=True))


# ---------------------------------------------------------------------------
# the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn,table", [
    (B._ds_taps, B.DS_FILTER), (B._mf_taps, B.DM_FILTER),
    (lambda dev: B._vco_tables(dev)[0], B._VCO_COS),
    (lambda dev: B._vco_tables(dev)[1], B._VCO_SIN),
    (B._sync_taps, B._SYNC)])
def test_device_tables_equal_the_module_tables_once_per_device(fn, table):
    dev = torch.device("cpu")
    got = fn(dev)
    assert got.dtype == torch.float32 and got.device == dev
    assert np.array_equal(got.numpy().ravel(), np.asarray(table, np.float32))
    assert fn(dev) is got


def test_host_vectors_upload_once_per_values_dtype_and_device():
    dev = torch.device("cpu")
    tu = B._host_vector((120000, 240000), torch.int64, dev)
    assert tu.dtype == torch.int64 and tu.tolist() == [120000, 240000]
    assert B._host_vector((120000, 240000), torch.int64, dev) is tu
    assert B._host_vector((120000, 240000), torch.int32, dev) is not tu
    assert B._flags(True, 3) == (True, True, True)
    assert B._flags([True, False], 2) == (True, False)


def test_ema_tables_equal_the_float64_host_tables():
    """``_const_ema_trajectory``'s tables, now kept on the device, hold
    the float64 host values rounded to float32, as before."""
    a, l, c = 1.0 - B.BIT_SMOOTH1, 128, 3
    tri_t, inter, pw_c, pw = B._ema_tables(a, l, c, torch.device("cpu"))
    k, cc = np.arange(l), np.arange(c)
    assert np.array_equal(tri_t.numpy()[3, 5], np.float32(a ** 2))
    assert np.array_equal(tri_t.numpy()[5, 3], np.float32(0.0))
    assert np.array_equal(inter.numpy()[2, 0], np.float32((a ** l) ** 1))
    assert np.array_equal(pw_c.numpy(),
                          np.power(a ** l, cc).astype(np.float32))
    assert np.array_equal(pw.numpy(), np.power(a, k + 1).astype(np.float32))
    assert B._ema_tables(a, l, c, torch.device("cpu"))[0] is tri_t


def test_device_tables_held_outlive_their_cache():
    """A holder keeps every table it is given: with the cache emptied,
    the same call under the holder returns the held tensor, and outside
    it the cache builds a new one."""
    from jsdr_tpu_torch.runtime.device import device_table, holding
    built = []

    @device_table(maxsize=1)
    def table(n, dev):
        built.append(n)
        return torch.arange(n, device=dev)

    dev, held = torch.device("cpu"), {}
    with holding(held) as tables:
        assert tables is held
        a = table(3, dev)
    assert table(3, dev) is a and built == [3]
    table(4, dev)
    table.cache_clear()
    with holding(held):
        assert table(3, dev) is a
    assert table(3, dev) is not a and built == [3, 4, 3]
    assert list(held.values()) == [a]


@pytest.mark.parametrize("table,args,want", [
    (fec_tables.viterbi_table_on, (), fec_tables.VITERBI_TABLE),
    (fec_tables.rs_table_on, (), fec_tables.rs_table()),
    (am_fm._weights, (21, 500, 1500, 44100.0), None),
    (am_fm._ramp, (64, 0.25), None)])
def test_fec_and_audio_tables_come_back_from_the_holder(table, args, want):
    """Kernel A's and B's tables and the audio demod's band-pass weights
    and carrier ramp are device tables: under a holder each comes back
    from the holder's dict, also after its cache was emptied, which
    outside the holder builds a new one. The FEC tables hold the
    module's host tables."""
    dev, held = torch.device("cpu"), {}
    with holding(held):
        a = table(*args, dev)
    assert held == {(table, (*args, dev)): a}
    if want is not None:
        assert np.array_equal(a.numpy(), want)
    table.cache_clear()
    with holding(held):
        assert table(*args, dev) is a
    assert table(*args, dev) is not a


def test_graph_step_holds_the_tables_of_its_key():
    """A step's first block holds every bounded table its key reads (the
    static mode's ramp and its host vectors), so emptying the
    module caches frees none of them; a new key lets them go."""
    cfg = B.BpskConfig(rate=RATE)
    tun = (11900.05, 24000.05)
    assert B.mix_mode_for(tun, RATE, (False, False)) == "static"
    step = GraphStep(slots=2, graphable=False)
    sig = _signal(1)
    blk = _block(sig, 0, "cpu")
    iq = CF(blk.re.expand(2, -1), blk.im.expand(2, -1))
    step(B.bpsk_block_batch, iq, B.bpsk_init_batch(cfg, 2, "cpu"), slot=0,
         cfg=cfg, tunings=tun)
    held = {fn for fn, _ in step._tables}
    assert {B._static_ramp, B._host_vector} <= held
    ramp = step._tables[next(k for k in step._tables
                             if k[0] is B._static_ramp)]
    B._static_ramp.cache_clear()
    assert any(v is ramp for v in step._tables.values())
    step(B.bpsk_block_batch, iq, B.bpsk_init_batch(cfg, 2, "cpu"), slot=0,
         cfg=cfg, tunings=TABS)
    assert not any(v is ramp for v in step._tables.values())


def test_telemetry_stage_on_the_cpu_runs_eagerly_and_counts_it():
    """Off a card every block takes the eager step, and the Session's
    tracer counts it; the frames are those of the eager step."""
    sig = _signal(5)
    s = Session(source=iter([sig]), block_samples=RATE, device="cpu")
    got = []
    s.pubsub.listen(lambda t, v: got.append(v) if t == "telemetry-frame"
                    else None)
    stage = TelemetryStage(B.BpskConfig(rate=RATE, fuse_mf=True), TABS,
                           device="cpu")
    assert s.run([stage]) == 5
    c = s.tracer.counters
    assert (c["telemetry.graph_replays"], c["telemetry.graph_captures"],
            c["telemetry.graph_eager"]) == (0, 0, 5)
    assert stage._step.last == "eager"
    assert got and all(f["ok"] for f in got)


def test_graph_step_state_sets():
    """The set a step reads: the set the state is, else the first after a
    copy of the state into it."""
    cfg = B.BpskConfig(rate=RATE)
    step = GraphStep(slots=4, graphable=False)
    st = B.bpsk_init_batch(cfg, 2, "cpu")
    st = st._replace(counters=st.counters + 7)
    assert step._source(st) == 0
    a, b = step._sets
    assert _equal(a, st) and a.counters is not st.counters
    assert step._source(a) == 0 and step._source(b) == 1


def test_graph_step_off_a_card_is_the_eager_step():
    cfg = B.BpskConfig(rate=RATE, fuse_mf=True)
    step = GraphStep(slots=4, graphable=False)   # as its stage rules here
    st_e = st_g = B.bpsk_init_batch(cfg, 2, "cpu")
    sig = _signal(3)
    for b in range(3):
        blk = _block(sig, b, "cpu")
        iq = CF(blk.re.expand(2, -1), blk.im.expand(2, -1))
        out_e, st_e = B.bpsk_block_batch(iq, cfg, st_e, TABS)
        out_g, st_g = step(B.bpsk_block_batch, iq, st_g, slot=b, cfg=cfg,
                           tunings=TABS)
        assert step.last == "eager"
        assert _equal(out_e, out_g) and _equal(st_e, st_g)


class _StubGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: the capture runs the step's
    body once, as a capture records it, and a replay runs nothing."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def stub_graphs(monkeypatch):
    @contextlib.contextmanager
    def graph(g, capture_error_mode=None):
        yield g

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)


def test_graph_step_key_separates_the_step_functions(stub_graphs):
    """The step function and its arguments are part of the key: a call
    with :func:`bpsk_block_batch_spectrum` after graphs of
    :func:`bpsk_block_batch` on the same shape, config and tunings drops
    them and runs eagerly once, a changed ``window`` does too, and going
    back drops the spectrum step's graphs. A (stub) capture of the
    spectrum step gives its whole output tuple and the state set it wrote,
    equal to the eager step's."""
    cfg = B.BpskConfig(rate=RATE)
    sig = _signal(1)
    iq = _tabs(_block(sig, 0, "cpu"))
    st0 = B.bpsk_init_batch(cfg, 2, "cpu")
    step = GraphStep(slots=2, graphable=True)       # as on a card
    tel = functools.partial(step, B.bpsk_block_batch, cfg=cfg, tunings=TABS)
    spec = functools.partial(step, B.bpsk_block_batch_spectrum, cfg=cfg,
                             tunings=TABS)
    _, st = tel(iq, st0, slot=0)
    assert step.last == "eager"
    _, st = tel(iq, st, slot=0)
    assert step.last == "capture" and len(step._graphs) == 1

    want = B.bpsk_block_batch_spectrum(iq, cfg, st, TABS)
    got = spec(iq, st, slot=1)
    assert step.last == "eager" and step._graphs == {} and step._sets == ()
    assert len(got) == 3 and _equal(got, want)
    want = B.bpsk_block_batch_spectrum(iq, cfg, got[-1], TABS)
    got = spec(iq, got[-1], slot=1)
    assert step.last == "capture" and list(step._graphs) == [(1, 0)]
    assert got[-1] is step._sets[1] and _equal(got, want)
    spec(iq, got[-1], window=False, slot=1)
    assert step.last == "eager" and step._graphs == {}
    spec(iq, st0, window=False, slot=1)
    assert step.last == "capture" and len(step._graphs) == 1
    tel(iq, st0, slot=0)
    assert step.last == "eager" and step._graphs == {}


# every kernel wrapper of the package that counts its launches: kernels 3
# and 4 (the spectrum step's), 1, 2, 5, 6, A and B's three, and the
# Session's S16LE conversion
LAUNCHING = [spectrum_front_fused, spectrum_fused, mix_decimate,
             timing_recover_batch, psd_waterfall, mix_decimate_mf,
             viterbi27_bytes, fec_check, decode_rs, encode_fec40, s16_to_cf]


@pytest.mark.parametrize("kernel", LAUNCHING)
def test_a_replay_counts_the_spectrum_kernels_launches(stub_graphs, kernel):
    """Each kernel wrapper is in the launch-counter registry: a capture
    leaves its launch counter as it was (it runs nothing), and each
    replay adds the launches its graph made, as the eager step would.
    The step here is a stub that launches ``kernel`` once."""
    assert kernel in _build.LAUNCH_COUNTERS

    def launching(iq, states, cfg=None, tunings=None, window=True):
        kernel.launches += 1          # what the kernel's wrapper counts
        return iq.re.sum(), states._replace(counters=states.counters + 1)

    cfg = B.BpskConfig(rate=RATE)
    iq = _tabs(_block(_signal(1), 0, "cpu"))
    st = B.bpsk_init_batch(cfg, 2, "cpu")
    step = GraphStep(slots=2, graphable=True)       # as on a card
    before = kernel.launches
    ran = []
    for b in range(4):
        _, st = step(launching, iq, st, slot=b % 2, cfg=cfg, tunings=TABS,
                     window=True)
        ran.append(step.last)
        assert kernel.launches - before == b + 1
    assert ran == ["eager", "capture", "capture", "replay"]
    assert [g.replays for g, _, _ in step._graphs.values()] == [2, 1]


def test_every_launch_counter_is_registered():
    """With every module of the package imported, the registry holds
    exactly the wrappers that count launches, and no module sets a
    counter by hand (a wrapper left out would drop out of its counter
    after a replay)."""
    root = Path(jsdr_tpu_torch.__file__).parent
    counting = set()
    for info in pkgutil.walk_packages([str(root)], "jsdr_tpu_torch."):
        mod = importlib.import_module(info.name)
        counting |= {fn for fn in vars(mod).values()
                     if callable(fn) and hasattr(fn, "launches")}
    assert counting == set(_build.LAUNCH_COUNTERS) == set(LAUNCHING)
    assert len(_build.LAUNCH_COUNTERS) == len(LAUNCHING)
    hand = [p.name for p in root.rglob("*.py")
            if re.search(r"^\w+\.launches = 0", p.read_text(), re.M)]
    assert hand == []


def test_the_graph_step_imports_nothing_from_demod():
    """``runtime/graph.py`` is the runtime's: importing it imports no
    module of ``demod/``, and it names no BPSK type."""
    import jsdr_tpu_torch.runtime.graph as G
    code = ("import sys, jsdr_tpu_torch.runtime.graph; "
            "print([m for m in sys.modules if '.demod' in m])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
    assert "bpsk" not in Path(G.__file__).read_text().lower()


def test_graph_step_holds_the_spectrum_tables_of_its_key():
    """The spectrum step's first block holds the spectrum's window and
    DFT tables (``spectrum_fused._tables_on``, a bounded cache), so
    emptying the cache frees none of them."""
    cfg = B.BpskConfig(rate=RATE)
    step = GraphStep(slots=2, graphable=False)
    iq = _tabs(_block(_signal(1), 0, "cpu"))
    step(B.bpsk_block_batch_spectrum, iq, B.bpsk_init_batch(cfg, 2, "cpu"),
         slot=0, cfg=cfg, tunings=TABS, window=True)
    held = [v for k, v in step._tables.items() if k[0] is _tables_on]
    assert len(held) == 1
    _tables_on.cache_clear()
    assert _tables_on(9600, True, "cpu") is not held[0]


def test_spectrum_stage_on_the_cpu_runs_eagerly_and_counts_it():
    """Off a card ``SpectrumTelemetryStage``'s step is eager every block
    and counted as such, beside the branch it took; its outputs are the
    eager :func:`bpsk_block_batch_spectrum`'s."""
    cfg = B.BpskConfig(rate=RATE)
    sig = _signal(3)
    s = Session(source=iter([sig]), block_samples=RATE, device="cpu")
    stage = SpectrumTelemetryStage(cfg, TABS, sync_every=2, device="cpu")
    lines = []
    s.pubsub.listen(lambda t, v: lines.append(v) if t == "waterfall-line"
                    else None)
    assert s.run([stage]) == 3
    c = s.tracer.counters
    assert (c["telemetry.graph_replays"], c["telemetry.graph_captures"],
            c["telemetry.graph_eager"]) == (0, 0, 3)
    assert c["spectrum_telemetry.staged"] == 3
    assert stage._step.last == "eager"
    st, want = B.bpsk_init_batch(cfg, 2, "cpu"), []
    for b in range(3):
        spec, _, st = B.bpsk_block_batch_spectrum(
            _tabs(_block(sig, b, "cpu")), cfg, st, TABS)
        want.append(waterfall_natural_order(spec.wf)[0].numpy())
    # the drains after blocks 1 and 2 publish those blocks' lines
    assert len(lines) == 2
    assert all(np.array_equal(a, b) for a, b in zip(lines, want[1:]))
    assert _equal(stage.state, st)


def _waterfall_eager(x: np.ndarray, dev, fft_n: int = 9600,
                     width: int = 960):
    """What ``SpectrumStage(waterfall_width=width)`` published before its
    graph step, for one block ``x``: the windowed rows through ``fft_cf``
    and kernel 5 (its plain version off a card), read back as (lines,
    dB)."""
    n = (len(x) // fft_n) * fft_n
    blk = _block(x[:n], 0, dev, n)
    w = hamming(fft_n, device=dev)
    rows = CF(blk.re.reshape(-1, fft_n) * w, blk.im.reshape(-1, fft_n) * w)
    db, lines = psd_waterfall(fft_cf(rows), width=width)
    return lines.cpu().numpy(), db.cpu().numpy()


def _waterfall_session(sig, size, dev):
    """A Session over ``sig`` in blocks of ``size`` and the list of its
    ('waterfall-line', 'fft-psd') pairs, one a block."""
    s = Session(source=iter([sig]), block_samples=size, device=dev)
    got = []

    def on(topic, v):
        if topic == "waterfall-line":
            got.append([v])
        elif topic == "fft-psd":
            got[-1].append(v)

    s.pubsub.listen(on)
    return s, got


def _same_pairs(got, want) -> bool:
    return len(got) == len(want) and all(
        a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
        for g, w in zip(got, want) for a, b in zip(g, w, strict=True))


def _own_memory(got) -> bool:
    """No array one block published shares memory with another block's."""
    return not any(np.shares_memory(a, b)
                   for i, g in enumerate(got) for h in got[i + 1:]
                   for a in g for b in h)


def _graph_counts(c, layer: str) -> tuple:
    return tuple(c.get(f"{layer}.graph_{k}", 0)
                 for k in ("replays", "captures", "eager"))


def test_waterfall_stage_on_the_cpu_runs_eagerly_and_counts_it():
    """Off a card ``SpectrumStage``'s waterfall step is eager every block
    and counted under ``spectrum.graph_*`` alone; it publishes what the
    stage published before its graph step, bit for bit, each block in
    memory of its own."""
    sig = _signal(3)
    s, got = _waterfall_session(sig, RATE, "cpu")
    stage = SpectrumStage(RATE, waterfall_width=960)
    assert s.run([stage]) == 3
    c = s.tracer.counters
    assert _graph_counts(c, "spectrum") == (0, 0, 3)
    assert not any(k.startswith("telemetry.") for k in c)
    assert not stage._step.graphable and stage._step.last == "eager"
    want = [_waterfall_eager(sig[b * RATE:(b + 1) * RATE], "cpu")
            for b in range(3)]
    assert _same_pairs(got, want) and _own_memory(got)


@pytest.fixture
def counted_k5(monkeypatch):
    """Kernel 5's plain version counting a launch, as the kernel's
    wrapper does on a card."""
    plain = k5.psd_waterfall_ref

    def counting(spec, width):
        psd_waterfall.launches += 1
        return plain(spec, width)

    monkeypatch.setattr(k5, "psd_waterfall_ref", counting)


def test_waterfall_stage_captures_once_then_replays(stub_graphs, counted_k5):
    """With a (stub) graph step, as on a card: one eager block, one
    capture, then replays, counted under ``spectrum.graph_*``; kernel 5
    counts a launch a block; the published lines and dB are those of the
    stage before its graph step, bit for bit (the blocks repeat: a stub
    replay runs nothing), each block's read back into a host array of its
    own, never the graph's buffer."""
    x = _signal(1)[:RATE]
    s, got = _waterfall_session(np.tile(x, 5), RATE, "cpu")
    stage = SpectrumStage(RATE, waterfall_width=960)
    stage._step = GraphStep(slots=1, graphable=True)     # as on a card
    before = psd_waterfall.launches
    assert s.run([stage]) == 5
    assert psd_waterfall.launches - before == 5
    assert _graph_counts(s.tracer.counters, "spectrum") == (3, 1, 1)
    assert list(stage._step._graphs) == [(0, 0)]
    ((graph, (packed,), _),) = stage._step._graphs.values()
    assert graph.replays == 4
    assert _same_pairs(got, [_waterfall_eager(x, "cpu")] * 5)
    assert _own_memory(got)
    assert not any(np.shares_memory(a, packed.numpy()) for g in got
                   for a in g)


def test_waterfall_step_holds_its_window():
    """The waterfall step's first block holds its Hamming window, a
    device table equal to ``hamming``'s bit for bit, so emptying the
    cache frees it; without ``window`` it reads none."""
    from jsdr_tpu_torch.ops.windows import hamming_on
    from jsdr_tpu_torch.runtime.executor import waterfall_step
    blk = _block(_signal(1), 0, "cpu")
    step = GraphStep(slots=1, graphable=False)
    step(waterfall_step, blk, None, slot=0, fft_n=9600, width=960,
         window=True)
    (held,) = step._tables.values()
    assert torch.equal(held, hamming(9600))
    hamming_on.cache_clear()
    assert hamming_on(9600, torch.device("cpu")) is not held
    step(waterfall_step, blk, None, slot=0, fft_n=9600, width=960,
         window=False)
    assert step._tables == {}


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from jsdr_tpu_torch.runtime.device import require_device
    return require_device("cuda")


class _CheckedMixin:
    """A telemetry stage that, at each drain, holds every pending block's
    outputs (and, with ``eager_spec``, the waterfall the drain publishes)
    to the eager step's (the blocks that differ go to ``bad``: the Session
    would take an exception here for a fault to retry), and raises once
    after the step of block ``fail_at``, before the block is queued."""

    def __init__(self, *a, eager_out, fail_at, eager_spec=None, **kw):
        super().__init__(*a, **kw)
        self.eager_out, self.fail_at = eager_out, fail_at
        self.eager_spec = eager_spec
        self.ids, self.checked, self.bad = [], [], []

    def _queue(self, out, session):
        block = session.tracer.block
        if block == self.fail_at:
            self.fail_at = None
            raise RuntimeError("injected after the step")
        self.ids.append(block)
        super()._queue(out, session)

    def _drain(self, session):
        ids, self.ids = self.ids, []
        if len(ids) != len(self._pending):
            self.bad.append(("pending", ids))
        for b, out in zip(ids, self._pending):
            self.checked.append(b)
            if not _equal(out, self.eager_out[b]):
                self.bad.append(b)
        if (self.eager_spec is not None and ids
                and not _equal(self._spec, self.eager_spec[ids[-1]])):
            self.bad.append(("spec", ids[-1]))
        super()._drain(session)


class _Checked(_CheckedMixin, TelemetryStage):
    pass


class _CheckedSpectrum(_CheckedMixin, SpectrumTelemetryStage):
    pass


@pytest.mark.card
@pytest.mark.parametrize("fuse_mf", [True, False])
def test_graphed_stage_is_bit_exact_to_the_eager_step(card, tmp_path,
                                                      fuse_mf):
    """13 blocks of two tabs through a graphed ``TelemetryStage`` in a
    Session: every pending block's outputs at its drain and the carried
    state after every block equal the eager step's bit for bit, through a
    retry (the step's first attempt at block 6 raises after its replay),
    a checkpoint saved and loaded after block 7, and a retune at block 10
    (a new key: eager, then new captures)."""
    n, fail_at, load_after, retune_at = 13, 6, 7, 10
    tabs2 = (12000.0, 18000.0)
    cfg = B.BpskConfig(rate=RATE, fuse_mf=fuse_mf)
    sig = _signal(n)
    eager_out, eager_st = [], []
    st = B.bpsk_init_batch(cfg, 2, card)
    for b in range(n):
        blk = _block(sig, b, card)
        iq = CF(blk.re.expand(2, -1), blk.im.expand(2, -1))
        out, st = B.bpsk_block_batch(iq, cfg, st,
                                     TABS if b < retune_at else tabs2)
        eager_out.append(out)
        eager_st.append(st)

    s = Session(source=iter([sig]), block_samples=RATE, device=card,
                checkpoint_path=tmp_path / "st.npz")
    stage = _Checked(cfg, TABS, device=card, eager_out=eager_out,
                     fail_at=fail_at)
    ran = []

    def on_block(topic, b):
        if topic != "audio-frame":
            return
        ran.append(stage._step.last)
        assert _equal(stage.state, eager_st[b]), f"state after block {b}"
        if b == load_after:
            s.save_checkpoint([stage])
            before = stage.state
            s.load_checkpoint([stage])
            assert stage.state is not before
        if b == retune_at - 1:
            stage.tunings = list(tabs2)

    s.pubsub.listen(on_block)
    kernels = (mix_decimate_mf if fuse_mf else mix_decimate,
               timing_recover_batch)
    before = [fn.launches for fn in kernels]
    assert s.run([stage]) == n
    # a replay counts its graph's kernels: once a step, the retry's too
    assert [fn.launches - b for fn, b in zip(kernels, before)] == [n + 1] * 2
    assert stage.bad == [] and stage.checked == list(range(n))
    assert s.dropped_blocks == {}
    c = s.tracer.counters
    assert c["session.retries"] == 1
    assert ran[0] == "eager" and ran[retune_at] == "eager"
    assert ran.count("eager") == 2
    assert c["telemetry.graph_eager"] == 2
    assert c["telemetry.graph_captures"] >= 4
    assert c["telemetry.graph_replays"] >= 3
    assert sum(c[k] for k in ("telemetry.graph_replays",
                              "telemetry.graph_captures",
                              "telemetry.graph_eager")) == n + 1
    assert ran[5] == "replay"


@pytest.mark.card
def test_a_collection_cannot_free_a_graph_inside_a_capture(card,
                                                          monkeypatch):
    """Dropped graphed stages in reference cycles are freed only by the
    garbage collector, and a graph freed inside another graph's capture
    breaks that capture (CUDA forbids the teardown there: the Session
    would retry the block). The collector is off while a step captures,
    so a collection it would make there (here forced wherever it is on)
    cannot run: a new stage captures its four graphs without a fault."""
    cfg = B.BpskConfig(rate=RATE, fuse_mf=True)
    sig = _signal(6)

    def run(stage, blocks):
        s = Session(source=iter([sig[:blocks * RATE]]), block_samples=RATE,
                    device=card)
        assert s.run([stage]) == blocks
        return s

    held = [TelemetryStage(cfg, TABS, device=card) for _ in range(2)]
    for st in held:
        run(st, 4)
        assert len(st._step._graphs) == 3
        st.cycle = st
    del held, st
    step = B.bpsk_block_batch

    def collecting(*a, **kw):
        if torch.cuda.is_current_stream_capturing() and gc.isenabled():
            gc.collect()
        return step(*a, **kw)

    monkeypatch.setattr(B, "bpsk_block_batch", collecting)
    s = run(TelemetryStage(cfg, TABS, device=card), 6)
    gc.collect()
    c = s.tracer.counters
    assert c["session.retries"] == 0 and s.dropped_blocks == {}
    assert c["telemetry.graph_captures"] == 4


# a batch in each front-end mode: mode, fuse_mf, tunings, dofft
MODES = {
    "pattern": ("pattern", True, TABS, None),
    "pattern-unfused": ("pattern", False, TABS, None),
    "general": ("general", False, (11900.0, 12000.5), None),
    "static": ("static", False, (11900.05, 24000.05), None),
    "dofft": ("dofft", True, (0.0, 0.0), (True, True)),
    "dofft-unfused": ("dofft", False, (0.0, 0.0), (True, True)),
    "mixed:pattern": ("mixed:pattern", True, (0.0, 12000.0), (True, False)),
    "mixed:general": ("mixed:general", True, (0.0, 11900.0), (True, False)),
    "mixed:static": ("mixed:static", False, (0.0, 11900.05), (True, False)),
}


@pytest.mark.card
@pytest.mark.parametrize("case", list(MODES))
def test_graph_step_in_each_front_end_mode(card, case):
    """Each front-end mode through ``GraphStep`` with slots as a stage
    of ``sync_every`` 2 gives them: bit for bit the eager step's outputs
    and state, and every mode captures and replays."""
    mode, fuse_mf, tun, dofft = MODES[case]
    cfg = B.BpskConfig(rate=RATE, fuse_mf=fuse_mf)
    assert B.mix_mode_for(tun, RATE, B._flags(
        False if dofft is None else dofft, 2)) == mode
    sig = _signal(6)
    step = GraphStep(slots=2, graphable=True)
    st_e = st_g = B.bpsk_init_batch(cfg, 2, card)
    ran = []
    for b in range(6):
        blk = _block(sig, b, card)
        iq = CF(blk.re.expand(2, -1), blk.im.expand(2, -1))
        out_e, st_e = B.bpsk_block_batch(iq, cfg, st_e, tun, dofft=dofft)
        out_g, st_g = step(B.bpsk_block_batch, iq, st_g, slot=b % 2,
                           cfg=cfg, tunings=tun, dofft=dofft)
        ran.append(step.last)
        assert _equal(out_e, out_g), f"outputs of block {b}"
        assert _equal(st_e, st_g), f"state after block {b}"
    assert ran == ["eager", "capture", "capture", "replay", "replay",
                   "replay"]


# SpectrumTelemetryStage's two branches: rate, block samples, tabs, merged
# on a card (the staged case's tabs lie off the 750 Hz grid, so neither
# rule merges it; the 0.1 s case only the card's rule merges)
SPECTRUM = {
    "merged-192k": (192000, 921600, (12000.0, 25500.0), True),
    "staged-96k": (96000, 96000, (12730.0, 24730.0), False),
    "merged-192k-100ms": (192000, 19200, (12000.0, 25500.0), True),
}
TOPICS = ("waterfall-line", "fft-peak", "telemetry-frame",
          "telemetry-counters")


def _same_topic(a, b) -> bool:
    """Two published values (arrays, tuples, dicts of them) equal."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_topic(a[k], b[k])
                                            for k in a)
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _spectrum_session(sig, size, dev):
    """A Session over ``sig`` and the list of the topics it publishes."""
    s = Session(source=iter([sig]), block_samples=size, device=dev)
    got = []
    s.pubsub.listen(lambda t, v: got.append((t, v)) if t in TOPICS
                    else None)
    return s, got


@pytest.mark.card
@pytest.mark.parametrize("case", list(SPECTRUM))
def test_graphed_spectrum_stage_is_bit_exact_to_the_eager_step(card, case):
    """12 blocks of two tabs through a graphed ``SpectrumTelemetryStage``
    (sync_every 4) in a Session, on the merged kernel 3 (192 kS/s in 4.8 s
    blocks, or in 0.1 s blocks, one FFT block a row, by the card's rule
    alone) or the staged pair (96 kS/s in 1 s blocks, off-grid tabs):
    every pending block's outputs and the drained block's waterfall at
    each drain, and the carried state after every block, equal the eager
    :func:`bpsk_block_batch_spectrum`'s bit for bit, through a retry (the
    step's first attempt at block 6 raises after its replay); the
    published 'waterfall-line', 'fft-peak', 'telemetry-frame' and
    'telemetry-counters' equal those of the same stage with an eager step;
    the branch's spectrum kernel counts a launch a step; and the stage
    counts ``spectrum_telemetry.merged_card`` a block where only the card's
    rule merges. 12 blocks of 0.1 s hold no whole frame, so that case
    publishes no good one."""
    rate, size, tabs, merged = SPECTRUM[case]
    n, fail_at = 12, 6
    cfg = B.BpskConfig(rate=rate)
    assert B.spectrum_step_merged(cfg, size, tabs, card) == merged
    card_only = merged and not B.spectrum_step_merged(cfg, size, tabs)
    sig = _station(rate, tabs, n * size / rate)
    eager_spec, eager_out, eager_st = [], [], []
    st = B.bpsk_init_batch(cfg, 2, card)
    for b in range(n):
        spec, out, st = B.bpsk_block_batch_spectrum(
            _tabs(_block(sig, b, card, size)), cfg, st, tabs)
        eager_spec.append(spec)
        eager_out.append(out)
        eager_st.append(st)

    s, got = _spectrum_session(sig, size, card)
    stage = _CheckedSpectrum(cfg, tabs, device=card, eager_out=eager_out,
                             eager_spec=eager_spec, fail_at=fail_at)
    ran = []

    def on_block(topic, b):
        if topic == "audio-frame":
            ran.append(stage._step.last)
            assert _equal(stage.state, eager_st[b]), f"state after block {b}"

    s.pubsub.listen(on_block)
    kernels = (spectrum_front_fused if merged else spectrum_fused,
               timing_recover_batch)
    before = [fn.launches for fn in kernels]
    assert s.run([stage]) == n
    # a replay counts its graph's kernels: once a step, the retry's too
    assert [fn.launches - b for fn, b in zip(kernels, before)] == [n + 1] * 2
    assert stage.bad == [] and stage.checked == list(range(n))
    assert s.dropped_blocks == {} and s.tracer.counters["session.retries"] == 1
    assert ran[0] == "eager" and ran.count("eager") == 1
    assert ran[fail_at] == "replay"
    # a step a block, the retry's too
    assert s.tracer.counters.get("spectrum_telemetry.merged_card", 0) == (
        n + 1 if card_only else 0)

    r, want = _spectrum_session(sig, size, card)
    eager = SpectrumTelemetryStage(cfg, tabs, device=card)
    # every slot outside the step's: eager
    eager._step = GraphStep(slots=0, graphable=True)
    assert r.run([eager]) == n
    assert r.tracer.counters["telemetry.graph_eager"] == n
    assert [t for t, _ in got] == [t for t, _ in want]
    assert all(_same_topic(a, b) for (_, a), (_, b) in zip(got, want))
    frames = [v for t, v in got if t == "telemetry-frame"]
    assert any(f["ok"] for f in frames) == (n * size / rate > 4.4)
    assert sum(t == "waterfall-line" for t, _ in got) == n // 4


@pytest.mark.card
def test_kernel_3_at_one_fft_block_a_row_equals_the_staged_pair(card):
    """At 192 kS/s in java-sdr's 0.1 s blocks (T = n = 19,200, S = 2: a
    grid of 2 CTAs, no cluster) the step runs kernel 3 by the card's rule
    alone; over 12 chained blocks of a frame train, each branch carrying
    its own state, every block's waterfall, peaks, outputs and state
    equal the staged pair's (``spectrum_waterfall``, then
    :func:`bpsk_block_batch`: kernels 4 and 1) bit for bit, and kernel 3
    launches once a block."""
    rate, size, tabs, _ = SPECTRUM["merged-192k-100ms"]
    n = 12
    cfg = B.BpskConfig(rate=rate)
    sig = _station(rate, tabs, n * size / rate)
    st_m = st_s = B.bpsk_init_batch(cfg, 2, card)
    before = spectrum_front_fused.launches
    for b in range(n):
        blk = _block(sig, b, card, size)
        x = CF(*(v.expand(2, -1).contiguous() for v in blk))
        spec, out_m, st_m = B.bpsk_block_batch_spectrum(x, cfg, st_m, tabs)
        wf, mx, idx = spectrum_waterfall(x, size)
        out_s, st_s = B.bpsk_block_batch(x, cfg, st_s, tabs)
        assert _equal(spec, B._waterfall_out(wf, mx, idx, rate)), b
        assert _equal(out_m, out_s), b
        assert _equal(st_m, st_s), b
    assert spectrum_front_fused.launches - before == n
    assert int(st_m.counters[0, 0]) == n * size


class _RaisesOnce(GraphStep):
    """A graph step of one slot whose call number ``at`` (from 0) raises
    after the step ran, before its stage reads the outputs back."""

    def __init__(self, at: int | None = None, **kw):
        super().__init__(**kw)
        self.at, self.calls = at, 0

    def __call__(self, *a, **kw):
        out = super().__call__(*a, **kw)
        self.calls += 1
        if self.calls - 1 == self.at:
            raise RuntimeError("injected after the step")
        return out


@pytest.mark.card
def test_graphed_waterfall_stage_publishes_what_the_eager_one_does(card):
    """12 s at 96 kS/s through ``SpectrumStage(waterfall_width=960)``:
    8 blocks of 1 s, the step's first attempt at block 6 raising after
    its replay (the Session retries the block), then the same stage in a
    Session of 0.5 s blocks (a new shape, a new key: eager, then a
    capture, then replays). The graphed stage publishes what the stage
    with an eager step publishes, bit for bit, and its first block what
    the stage published before its graph step; every block in memory of
    its own; kernel 5 counts a launch a step, the failed attempt's too."""
    n, fail_at, size2 = 8, 6, RATE // 2
    sig = _signal(12)

    def run(step):
        stage = SpectrumStage(RATE, waterfall_width=960)
        stage._step = step
        got, ran, counts = [], [], []
        for x, size in ((sig[:n * RATE], RATE), (sig[n * RATE:], size2)):
            s, out = _waterfall_session(x, size, card)
            s.pubsub.listen(lambda t, v: ran.append(step.last)
                            if t == "audio-frame" else None)
            assert s.run([stage]) == len(x) // size
            assert s.dropped_blocks == {}
            counts.append(_graph_counts(s.tracer.counters, "spectrum"))
            got += out
        return got, ran, counts

    before = psd_waterfall.launches
    got, ran, counts = run(_RaisesOnce(fail_at, slots=1, graphable=True))
    assert psd_waterfall.launches - before == n + 1 + 8
    want, _, eager = run(GraphStep(slots=0, graphable=True))
    assert eager == [(0, 0, n), (0, 0, 8)]
    assert ran == (["eager", "capture"] + ["replay"] * (n - 2)
                   + ["eager", "capture"] + ["replay"] * 6)
    assert counts == [(n - 2, 1, 1), (6, 1, 1)]
    assert _same_pairs(got, want) and _own_memory(got)
    assert _same_pairs(got[:1], [_waterfall_eager(sig[:RATE], card)])
    assert [g[1].shape for g in got] == [(10, 9600)] * n + [(5, 9600)] * 8


@pytest.mark.card
def test_spectrum_stage_counts_each_block_once(card):
    """At 192 kS/s in 4.8 s blocks the stage's step counts each block
    once: eager at the first, its four captures (a slot and state set
    each, sync_every 4) inside the first 8 blocks, replays after; every
    block runs the merged kernel 3."""
    rate, size, tabs, _ = SPECTRUM["merged-192k"]
    n = 12
    sig = _station(rate, tabs, n * size / rate)
    s = Session(source=iter([sig]), block_samples=size, device=card)
    stage = SpectrumTelemetryStage(B.BpskConfig(rate=rate), tabs,
                                   device=card)
    ran = []
    s.pubsub.listen(lambda t, v: ran.append(stage._step.last)
                    if t == "audio-frame" else None)
    assert s.run([stage]) == n
    c = s.tracer.counters
    counts = [c.get(f"telemetry.graph_{k}", 0)
              for k in ("replays", "captures", "eager")]
    assert sum(counts) == n and counts == [n - 5, 4, 1]
    assert all(i < 8 for i, r in enumerate(ran) if r != "replay")
    assert ran[0] == "eager" and set(ran[8:]) == {"replay"}
    assert c["spectrum_telemetry.merged"] == n


@pytest.mark.card
@pytest.mark.parametrize("cls", [TelemetryStage, SpectrumTelemetryStage])
def test_graphed_stage_drains_as_the_masked_reads_did(card, cls):
    """13 blocks of frame trains on two tabs through a graphed stage whose
    drain makes no synchronising call but its waits (CUDA's sync debug
    mode raises on one), against a stage of the same class whose drain is
    the masked-read loop it replaced (``tests/test_torch_drain_readback.
    py``): the same published stream, topic for topic and byte for byte,
    through three full drains and ``finish()``'s last; each drain waits on
    the card once, and once more where it decoded."""
    from test_torch_drain_readback import _plain, _reference_drain

    n = 13
    sig = _signal(n)
    # kernels A and B built and their tables on the card before the drains
    fec_decode(torch.full((1, 5200), 0x40, dtype=torch.uint8, device=card))
    torch.cuda.synchronize()

    class Strict(cls):
        def _drain(self, session):
            torch.cuda.set_sync_debug_mode("error")
            try:
                super()._drain(session)
            finally:
                torch.cuda.set_sync_debug_mode("default")

    class Reference(cls):
        def _drain(self, session):
            _reference_drain(self, session)

    streams, counters = [], []
    for stage_cls in (Strict, Reference):
        s = Session(source=iter([sig]), block_samples=RATE, device=card)
        got = []
        s.pubsub.listen(lambda t, v: got.append((t, v)))
        assert s.run([stage_cls(B.BpskConfig(rate=RATE), TABS,
                                device=card)]) == n
        streams.append([_plain(v) for v in got])
        counters.append(s.tracer.counters)
    assert streams[0] == streams[1]
    topics = [t for (_, t), _ in streams[0]]
    drains = "".join("d" if t == "telemetry-counters" else
                     "f" if t == "telemetry-frame" else "" for t in topics)
    decoded = drains.split("d")[1:]
    c = counters[0]
    assert c["drain.runs"] == len(decoded) == 4
    assert c["telemetry.graph_replays"] > 0
    assert sum(map(bool, decoded)) >= 2
    assert c["drain.waits"] == c["drain.runs"] + sum(map(bool, decoded))
    assert c["drain.hits"] == sum(map(len, decoded))
