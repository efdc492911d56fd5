"""The cell ``fcd2-192k-offgrid-tabs2.quiet`` as ``BENCHMARK.json`` lists
it: it loads from the real file with its two per-layer metrics; a whole
run on the CPU at a small size (8 blocks, as
``test_portbench_fcd2_quiet.py``'s) is correct and ran the general front
end and the staged spectrum step every block, and its control and the
state-unchanged fault are not correct; ``telemetry.general_front_pct``
reads 100 from a small profiled run of the cell's stages in the port's
Session and None without a ``telemetry.front.*`` counter (as the commit
before it gives); ``k4_spectrum_wf_roofline`` reads a number from a
trace that holds kernel 4's calls and None from one without them; and
kernel 4's work function reproduces the kernel's bound in PERF.md. Tests
marked ``card`` run the control and a traced run at the cell's own size
on the card."""

import time

import numpy as np
import pytest
import torch

from portbench import harness, trace
from portbench.cells import load_cell, metric_reader
from portbench.roofline import k4_spectrum_wf
from portbench.roofline.peaks import bound_s

CELL = "fcd2-192k-offgrid-tabs2.quiet"
SEED = 2**31 + 2323
NEW = ("telemetry.general_front_pct", "k4_spectrum_wf_roofline")
BLOCKS = 3
# kernel 4's name as the card's trace gives it
K4_NAME = ("void (anonymous namespace)::spectrum_wf_kernel<1>(float const*, "
           "float const*, float const*, jsdr_spec::Plan, float*, float*, "
           "int*, int, int, int, int, float)")


def test_cell_loads_from_the_benchmark():
    c = load_cell(CELL)
    assert (c.config_name, c.traffic_name, c.chips) == (
        "fcd2-192k-offgrid-tabs2", "quiet", 1)
    cfg = c.config
    assert cfg["rate"] == 192000 and cfg["block_samples"] == 921600
    assert cfg["block_samples"] // cfg["chunk_samples"] == 48
    assert [s["class"] for s in cfg["stages"]] == ["SpectrumTelemetryStage"]
    assert list(harness.tunings(cfg)) == [12730, 26230]
    assert {m["name"] for m in c.end_to_end} == {"stream_msps", "setup_s"}
    assert {m["name"] for m in c.per_layer} == set(NEW)
    assert all(m["moves"] == "stream_msps" for m in c.per_layer)


def test_tabs_are_off_the_grid():
    """Neither tab is a multiple of 1500 Hz, so the port takes the general
    front end and the staged spectrum step at the cell's block."""
    from jsdr_tpu_torch.demod.bpsk import (BpskConfig, mix_mode_for,
                                           spectrum_step_merged)

    cfg = load_cell(CELL).config
    tun = harness.tunings(cfg)
    assert all(t % 1500 for t in tun)
    assert mix_mode_for(tun, cfg["rate"], [False, False]) == "general"
    assert not spectrum_step_merged(BpskConfig(rate=cfg["rate"]),
                                    cfg["block_samples"], tun)


def _small(control=False, fault=None):
    c = load_cell(CELL)
    c.config["check_start_groups"] = 2
    return harness.run(c, SEED, 0, False, "cpu", time.perf_counter(),
                       control=control, max_blocks=8, fault=fault)


def _state_unchanged(stages):
    st = next(s for s in stages if hasattr(s, "_drain"))
    process = st.process

    def frozen(block, session):
        before = st.state
        process(block, session)
        st.state = before

    st.process = frozen


def test_program_is_correct_on_the_general_front_end():
    from jsdr_tpu_torch.runtime.log import latest

    res = _small()
    assert res["correct"], res["check"]
    assert res["attempted"] == 8 and res["failed"] == 0
    assert dict((n, v) for n, v, _ in res["check"])["groups_checked"] == 4
    assert set(res["metrics"]) == {"stream_msps", "setup_s"}
    c = latest().counters
    blocks = harness.WARM_BLOCKS + 8
    assert c["session.blocks"] == blocks
    assert c["telemetry.front.general"] == blocks
    assert c["spectrum_telemetry.staged"] == blocks
    assert not any(k.startswith("telemetry.front.") and k != (
        "telemetry.front.general") for k in c)
    assert "spectrum_telemetry.merged" not in c


def test_control_is_not_correct():
    assert not _small(control=True)["correct"]


def test_state_unchanged_is_not_correct():
    assert not _small(fault=_state_unchanged)["correct"]


def _record(trace_summary=None, spans=()) -> harness.RunRecord:
    cell = load_cell(CELL)
    cfg = cell.config
    return harness.RunRecord(
        cell=cell, block_samples=cfg["block_samples"], warm_blocks=1,
        n_blocks=BLOCKS, t_window=0.0, t_end=0.0, handin=[],
        block_start=[], ticks=[], spans=list(spans), drains=[],
        chunk_samples=cfg["chunk_samples"], trace=trace_summary,
        untraced_from=1)


@pytest.fixture(scope="module")
def profiled():
    """``BLOCKS`` blocks of noise through the cell's stages in the port's
    Session on the CPU, under the profiler as a ``--trace 1`` run is."""
    from torch.profiler import ProfilerActivity, profile

    from jsdr_tpu_torch.runtime.executor import Session

    cfg = load_cell(CELL).config
    n = cfg["chunk_samples"]
    raw = np.random.default_rng(23).integers(
        -3000, 3000, 2 * cfg["block_samples"] * BLOCKS, dtype=np.int16)
    chunks = [raw[i:i + 2 * n] for i in range(0, len(raw), 2 * n)]
    session = Session(source=iter(chunks),
                      block_samples=cfg["block_samples"], device="cpu",
                      timers=harness.SpanTimers())
    with profile(activities=[ProfilerActivity.CPU]):
        assert session.run(harness.build_stages(cfg, "cpu")) == BLOCKS
    return _record(spans=session.timers.spans)


def test_general_front_reader_reads_the_program(profiled):
    assert metric_reader("telemetry.general_front_pct")(profiled) == 100


def _tracer(counters):
    from jsdr_tpu_torch.runtime.log import StageTimers

    tr = StageTimers(spans=True)
    for name, n in counters.items():
        tr.count(name, n)
    return tr


def test_general_front_reader_reads_nothing_without_its_counter(
        profiled, monkeypatch):
    """The commit before it counted the graph step and the spectrum
    step's branch, and no front end; counters without any block give
    nothing to divide by; a pattern front end reads 0."""
    from jsdr_tpu_torch.runtime import log

    read = metric_reader("telemetry.general_front_pct")
    monkeypatch.setattr(log, "_latest", _tracer(
        {"session.blocks": BLOCKS, "telemetry.graph_eager": BLOCKS,
         "spectrum_telemetry.staged": BLOCKS}))
    assert read(profiled) is None
    monkeypatch.setattr(log, "_latest", _tracer(
        {"telemetry.front.general": BLOCKS}))
    assert read(profiled) is None
    monkeypatch.setattr(log, "_latest", _tracer(
        {"session.blocks": 4, "telemetry.front.pattern": 4}))
    assert read(profiled) == 0
    monkeypatch.delattr(log, "latest")
    assert read(profiled) is None


def _summary(kernels: dict) -> trace.Summary:
    return trace.Summary(first_block=1, last_block=BLOCKS, window_s=1.0,
                         busy_s=0.1, launches=0, kernels=kernels)


def test_k4_reader_reads_kernel_4s_calls():
    """From a trace with kernel 4's calls: the least time of the cell's
    logical work over their mean device time; none without them."""
    read = metric_reader("k4_spectrum_wf_roofline")
    calls = [50e-6, 60e-6, 70e-6]
    least, by = bound_s(*k4_spectrum_wf.work(921600, 19200, 10))
    assert by == "bytes"
    got = read(_record(_summary({K4_NAME: calls,
                                 "timing_kernel": [1e-3]})))
    assert got == pytest.approx(100.0 * least / 60e-6)
    assert 0 < got < 50
    assert read(_record(_summary({"spec_front_kernel<1>": calls}))) is None
    assert read(_record(None)) is None


def test_k4_work_reproduces_perf_md_bound():
    """With a stream row a tab, kernel 4's own bound in PERF.md: 0.0323 ms
    at 128 x 96,000 (n = 9,600, q = 5), bytes; the cell's logical work
    reads the stream once."""
    least, by = bound_s(*k4_spectrum_wf.work(96000, 9600, 5, 128))
    assert least * 1e3 == pytest.approx(0.0323, abs=5e-5) and by == "bytes"
    rows = k4_spectrum_wf.work(921600, 19200, 10, 2)
    once = k4_spectrum_wf.work(921600, 19200, 10)
    assert rows[1] - once[1] == pytest.approx(
        8.0 * 921600 + 4.0 * 48 * 15 * 128 + 8.0 * 48)
    assert rows[0] == pytest.approx(2 * once[0])


@pytest.mark.card
def test_control_at_full_size_on_the_card():
    """The control (the reference in bfloat16 in the program's place) on
    the card at the cell's own size, a short window: not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (31, 32, 33):
        res = harness.run(load_cell(CELL), 2**31 + seed, 3, False, "cuda",
                          time.perf_counter(), control=True)
        print("control", seed, res["check"])
        assert not res["correct"], res["check"]


@pytest.mark.card
def test_traced_run_on_the_card_reads_both_metrics():
    """A short traced run at the cell's size on the card: correct, every
    block on the general front end with graph replays, and kernel 4's
    share a number at most 100 / tabs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = harness.run(load_cell(CELL), 2**31 + 34, 3, True, "cuda",
                      time.perf_counter())
    print("traced", res["metrics"], res["check"])
    assert res["correct"], res["check"]
    m = res["metrics"]
    assert m["telemetry.general_front_pct"]["value"] == 100
    assert 0 < m["k4_spectrum_wf_roofline"]["value"] <= 50
