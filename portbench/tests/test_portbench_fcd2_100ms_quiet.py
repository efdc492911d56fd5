"""The cell ``fcd2-192k-100ms-tabs2.quiet`` as ``BENCHMARK.json`` lists
it: it loads from the real file with its one per-layer metric, and its
configuration is the merged configuration's but for the block length
(java-sdr's 0.1 s); only the card's rule merges that block. A whole run
on the CPU at a small size is correct on the staged pair (the CPU keeps
the reference's rule) and on the merged branch (the rule pointed at a
card, kernel 3's plain version in its place), and its control and the
state-unchanged fault are not correct; ``spectrum_telemetry.merged_card_pct``
reads 100 from a small profiled run of the cell's stages in the port's
Session on the merged branch, and None without a
``spectrum_telemetry.merged_card`` counter (as the commit before it
gives). Tests marked ``card`` run the control and a traced run at the
cell's own size on the card."""

import json
import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.cells import BENCHMARK, load_cell, metric_reader

CELL = "fcd2-192k-100ms-tabs2.quiet"
SEED = 2**31 + 2525
NEW = ("spectrum_telemetry.merged_card_pct",)
BLOCKS = 12
SAME_AS_MERGED = ("rate", "chunk_samples", "tabs", "stages", "torch_threads")


def test_cell_loads_from_the_benchmark():
    c = load_cell(CELL)
    assert (c.config_name, c.traffic_name, c.chips) == (
        "fcd2-192k-100ms-tabs2", "quiet", 1)
    cfg = c.config
    assert cfg["rate"] == 192000 and cfg["block_samples"] == 19200
    assert cfg["chunk_samples"] == 19200
    assert [s["class"] for s in cfg["stages"]] == ["SpectrumTelemetryStage"]
    assert list(harness.tunings(cfg)) == [12000, 25500]
    assert {m["name"] for m in c.end_to_end} == {"stream_msps", "setup_s"}
    assert {m["name"] for m in c.per_layer} == set(NEW)
    assert all(m["moves"] == "stream_msps" for m in c.per_layer)
    merged = load_cell("fcd2-192k-merged-tabs2.quiet").config
    assert {k: cfg[k] for k in SAME_AS_MERGED} == {
        k: merged[k] for k in SAME_AS_MERGED}
    entry = next(e for e in json.loads(BENCHMARK.read_text())["configs"]
                 if e["name"] == c.config_name)
    assert entry["reduced"] == [] and len(entry["source"]) <= 200


def test_only_the_cards_rule_merges_the_block():
    """0.1 s at 192 kS/s is one FFT block: no multiple of the reference's
    2, so the CPU stages it and a card runs kernel 3."""
    from jsdr_tpu_torch.demod.bpsk import BpskConfig, spectrum_step_merged

    cfg = load_cell(CELL).config
    bcfg, tun = BpskConfig(rate=cfg["rate"]), harness.tunings(cfg)
    assert not spectrum_step_merged(bcfg, cfg["block_samples"], tun)
    assert not spectrum_step_merged(bcfg, cfg["block_samples"], tun, "cpu")
    assert spectrum_step_merged(bcfg, cfg["block_samples"], tun, "cuda")


@pytest.fixture
def card_rule(monkeypatch):
    """The card's rule wherever a device is named, so that the CPU runs
    the merged branch (kernel 3's plain version) and the stage counts
    ``spectrum_telemetry.merged_card``, as a card does."""
    from jsdr_tpu_torch.demod import bpsk

    rule = bpsk.spectrum_step_merged
    monkeypatch.setattr(
        bpsk, "spectrum_step_merged",
        lambda cfg, t_len, tunings, device=None: rule(
            cfg, t_len, tunings, None if device is None else "cuda"))


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


def _assert_correct(res, branch):
    from jsdr_tpu_torch.runtime.log import latest

    assert res["correct"], res["check"]
    assert res["attempted"] == 8 and res["failed"] == 0
    assert dict((n, v) for n, v, _ in res["check"])["groups_checked"] == 4
    assert set(res["metrics"]) == {"stream_msps", "setup_s"}
    c = latest().counters
    blocks = harness.WARM_BLOCKS + 8
    assert c["session.blocks"] == blocks
    assert c["telemetry.front.pattern"] == blocks
    assert c[f"spectrum_telemetry.{branch}"] == blocks
    return c


def test_program_is_correct_on_the_staged_pair():
    c = _assert_correct(_small(), "staged")
    assert "spectrum_telemetry.merged" not in c
    assert "spectrum_telemetry.merged_card" not in c


def test_program_is_correct_on_the_merged_branch(card_rule):
    c = _assert_correct(_small(), "merged")
    assert c["spectrum_telemetry.merged_card"] == c["session.blocks"]
    assert "spectrum_telemetry.staged" not in c


def test_control_is_not_correct():
    assert not _small(control=True)["correct"]


@pytest.mark.parametrize("rule", ["reference", "card"])
def test_state_unchanged_is_not_correct(rule, request):
    if rule == "card":
        request.getfixturevalue("card_rule")
    assert not _small(fault=_state_unchanged)["correct"]


@pytest.fixture
def profiled(card_rule):
    """``BLOCKS`` blocks of noise through the cell's stages in the port's
    Session on the CPU, on the merged branch, under the profiler as a
    ``--trace 1`` run is."""
    from torch.profiler import ProfilerActivity, profile

    from jsdr_tpu_torch.runtime.executor import Session

    cell = load_cell(CELL)
    cfg = cell.config
    n = cfg["chunk_samples"]
    raw = np.random.default_rng(25).integers(
        -3000, 3000, 2 * cfg["block_samples"] * BLOCKS, dtype=np.int16)
    chunks = [raw[i:i + 2 * n] for i in range(0, len(raw), 2 * n)]
    session = Session(source=iter(chunks),
                      block_samples=cfg["block_samples"], device="cpu",
                      timers=harness.SpanTimers())
    with profile(activities=[ProfilerActivity.CPU]):
        assert session.run(harness.build_stages(cfg, "cpu")) == BLOCKS
    return harness.RunRecord(
        cell=cell, block_samples=cfg["block_samples"], warm_blocks=1,
        n_blocks=BLOCKS, t_window=0.0, t_end=0.0, handin=[],
        block_start=[], ticks=[], spans=session.timers.spans, drains=[],
        chunk_samples=n, untraced_from=1)


def test_merged_card_reader_reads_the_program(profiled):
    assert metric_reader("spectrum_telemetry.merged_card_pct")(
        profiled) == 100


def _tracer(counters):
    from jsdr_tpu_torch.runtime.log import StageTimers

    tr = StageTimers(spans=True)
    for name, n in counters.items():
        tr.count(name, n)
    return tr


def test_merged_card_reader_reads_nothing_without_its_counter(monkeypatch):
    """The commit before it staged every 0.1 s block and had no such
    counter; counters without any block give nothing to divide by; a
    counter on every block reads 100, on half of them 50."""
    from jsdr_tpu_torch.runtime import log

    read = metric_reader("spectrum_telemetry.merged_card_pct")
    rec = None
    monkeypatch.setattr(log, "_latest", _tracer(
        {"session.blocks": BLOCKS, "telemetry.graph_replays": BLOCKS,
         "spectrum_telemetry.staged": BLOCKS,
         "telemetry.front.pattern": BLOCKS}))
    assert read(rec) is None
    monkeypatch.setattr(log, "_latest", _tracer(
        {"spectrum_telemetry.merged_card": BLOCKS}))
    assert read(rec) is None
    monkeypatch.setattr(log, "_latest", _tracer(
        {"session.blocks": BLOCKS, "spectrum_telemetry.merged": BLOCKS,
         "spectrum_telemetry.merged_card": BLOCKS}))
    assert read(rec) == 100
    monkeypatch.setattr(log, "_latest", _tracer(
        {"session.blocks": 2 * BLOCKS, "spectrum_telemetry.merged": BLOCKS,
         "spectrum_telemetry.merged_card": BLOCKS}))
    assert read(rec) == 50
    monkeypatch.delattr(log, "latest")
    assert read(rec) is None


@pytest.mark.card
def test_control_at_full_size_on_the_card():
    """The control (the reference in bfloat16 in the program's place) on
    the card at the cell's own size, a short window: not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (41, 42, 43):
        res = harness.run(load_cell(CELL), 2**31 + seed, 3, False, "cuda",
                          time.perf_counter(), control=True)
        print("control", seed, res["check"])
        assert not res["correct"], res["check"]


@pytest.mark.card
def test_traced_run_on_the_card_reads_its_metric():
    """A short traced run at the cell's size on the card: correct, and
    every block on kernel 3 by the card's rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = harness.run(load_cell(CELL), 2**31 + 44, 3, True, "cuda",
                      time.perf_counter())
    print("traced", res["metrics"], res["check"])
    assert res["correct"], res["check"]
    assert res["metrics"]["spectrum_telemetry.merged_card_pct"][
        "value"] == 100
