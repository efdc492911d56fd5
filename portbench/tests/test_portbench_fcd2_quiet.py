"""The cell ``fcd2-192k-merged-tabs2.quiet`` as ``BENCHMARK.json`` lists it:
it loads from the real file with its four per-layer metrics; a whole run
on the CPU at a small size (as ``test_portbench_harness.py``'s) is
correct, and its control and the state-unchanged fault are not; and each
of its three program readers (``spectrum_telemetry.step_ms``,
``spectrum_telemetry.merged_pct``, ``session.framer_copy_mb``) reads a
number from a small profiled run of the cell's stages in the port's
Session, and None from a run without its span or counter (as the commit
before them gives). A test marked ``card`` runs the control at the cell's
own size on the card."""

import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.cells import load_cell, metric_reader

CELL = "fcd2-192k-merged-tabs2.quiet"
SEED = 2**31 + 1919
NEW = ("spectrum_telemetry.step_ms", "spectrum_telemetry.merged_pct",
       "session.framer_copy_mb")
BLOCKS = 3


def test_cell_loads_from_the_benchmark():
    c = load_cell(CELL)
    assert (c.config_name, c.traffic_name, c.chips) == (
        "fcd2-192k-merged-tabs2", "quiet", 1)
    cfg = c.config
    assert cfg["rate"] == 192000 and cfg["block_samples"] == 921600
    assert cfg["block_samples"] // cfg["chunk_samples"] == 48
    assert [s["class"] for s in cfg["stages"]] == ["SpectrumTelemetryStage"]
    assert list(harness.tunings(cfg)) == [12000, 25500]
    assert {m["name"] for m in c.end_to_end} == {"stream_msps", "setup_s"}
    assert {m["name"] for m in c.per_layer} == {
        "k3_spec_front_roofline", *NEW}
    assert all(m["moves"] == "stream_msps" for m in c.per_layer)


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


def test_program_is_correct():
    res = _small()
    assert res["correct"], res["check"]
    assert res["attempted"] == 8 and res["failed"] == 0
    assert dict((n, v) for n, v, _ in res["check"])["groups_checked"] == 4
    assert set(res["metrics"]) == {"stream_msps", "setup_s"}


def test_control_is_not_correct():
    assert not _small(control=True)["correct"]


def test_state_unchanged_is_not_correct():
    assert not _small(fault=_state_unchanged)["correct"]


def _run(profiled: bool) -> harness.RunRecord:
    """``BLOCKS`` blocks of noise through the cell's stages in the port's
    Session on the CPU, profiled as a ``--trace 1`` run is (the
    program's spans on) or not."""
    from torch.profiler import ProfilerActivity, profile

    from jsdr_tpu_torch.runtime.executor import Session

    cell = load_cell(CELL)
    cfg = cell.config
    n = cfg["chunk_samples"]
    raw = np.random.default_rng(19).integers(
        -3000, 3000, 2 * cfg["block_samples"] * BLOCKS, dtype=np.int16)
    chunks = [raw[i:i + 2 * n] for i in range(0, len(raw), 2 * n)]
    session = Session(source=iter(chunks),
                      block_samples=cfg["block_samples"], device="cpu",
                      timers=harness.SpanTimers())
    stages = harness.build_stages(cfg, "cpu")
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            blocks = session.run(stages)
    else:
        blocks = session.run(stages)
    assert blocks == BLOCKS
    return harness.RunRecord(
        cell=cell, block_samples=cfg["block_samples"], warm_blocks=1,
        n_blocks=blocks, t_window=0.0, t_end=0.0, handin=[],
        block_start=[], ticks=[], spans=session.timers.spans, drains=[],
        chunk_samples=n, untraced_from=1)


@pytest.fixture(scope="module")
def profiled():
    return _run(True)


def test_readers_read_the_program(profiled):
    assert metric_reader("spectrum_telemetry.step_ms")(profiled) > 0
    assert metric_reader("spectrum_telemetry.merged_pct")(profiled) == 100
    assert metric_reader("session.framer_copy_mb")(profiled) == (
        921600 * 4 / 1e6)


def _tracer(counters, spans=()):
    from jsdr_tpu_torch.runtime.log import StageTimers

    tr = StageTimers(spans=True)
    for name, n in counters.items():
        tr.count(name, n)
    for block in range(BLOCKS):
        tr.begin_block(block)
        for name in ("session.frame", *spans):
            with tr.span(name):
                pass
    return tr


def test_readers_read_nothing_without_their_span_or_counter(
        profiled, monkeypatch):
    """The commit before them: the stage's step opened ``telemetry.step``
    and counted only ``telemetry.graph_eager``, the Session no framer
    bytes."""
    from jsdr_tpu_torch.runtime import log

    monkeypatch.setattr(log, "_latest", _tracer(
        {"session.blocks": BLOCKS, "telemetry.graph_eager": BLOCKS},
        spans=("h2d", "spectrum-telemetry", "telemetry.step")))
    assert all(metric_reader(name)(profiled) is None for name in NEW)
    monkeypatch.setattr(log, "_latest", _tracer(
        {"spectrum_telemetry.staged": BLOCKS,
         "session.framer_bytes": 10**6}))
    # counters without any block: nothing to divide by
    assert metric_reader("spectrum_telemetry.merged_pct")(profiled) is None
    assert metric_reader("session.framer_copy_mb")(profiled) is None
    monkeypatch.setattr(log, "_latest", _tracer(
        {"session.blocks": 4, "spectrum_telemetry.staged": 4}))
    assert metric_reader("spectrum_telemetry.merged_pct")(profiled) == 0


def test_readers_read_nothing_with_spans_off_or_no_tracer(monkeypatch):
    run = _run(False)
    assert metric_reader("spectrum_telemetry.step_ms")(run) is None
    from jsdr_tpu_torch.runtime import log

    monkeypatch.delattr(log, "latest")
    assert all(metric_reader(name)(run) is None for name in NEW)


@pytest.mark.card
def test_control_at_full_size_on_the_card():
    """The control (the reference in bfloat16 in the program's place) on
    the card at the cell's own size, a short window: not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (21, 22, 23):
        res = harness.run(load_cell(CELL), 2**31 + seed, 3, False, "cuda",
                          time.perf_counter(), control=True)
        print("control", seed, res["check"])
        assert not res["correct"], res["check"]
