"""The reader of the program's counters, ``telemetry.graph_replay_pct``
(``metrics/<name>.py`` with source ``program_counter``): the share of the
run's blocks whose telemetry step replayed a CUDA graph, from the tracer
of the latest ``Session.run``; None where there are no such counters (a
program without them, as the commit before them, or without a tracer)."""

import numpy as np
import pytest

from portbench import harness
from portbench.cells import load_cell, metric_reader

NAME = "telemetry.graph_replay_pct"


def _tracer(**counts):
    from jsdr_tpu_torch.runtime.log import StageTimers

    tr = StageTimers()
    for name, n in counts.items():
        tr.count(name.replace("__", "."), n)
    return tr


@pytest.mark.parametrize("counts,want", [
    ({"session__blocks": 200, "telemetry__graph_replays": 195,
      "telemetry__graph_captures": 4, "telemetry__graph_eager": 1}, 97.5),
    ({"session__blocks": 8, "telemetry__graph_eager": 8}, 0.0),
])
def test_reads_the_share_of_replayed_blocks(monkeypatch, counts, want):
    from jsdr_tpu_torch.runtime import log

    monkeypatch.setattr(log, "_latest", _tracer(**counts))
    assert metric_reader(NAME)(None) == pytest.approx(want)


@pytest.mark.parametrize("counts", [
    {"session__blocks": 12},                        # no graph counters
    {"telemetry__graph_replays": 3},                # no blocks
    {"session__blocks": 12, "drain__runs": 3},      # other counters only
])
def test_reads_nothing_without_the_counters(monkeypatch, counts):
    from jsdr_tpu_torch.runtime import log

    monkeypatch.setattr(log, "_latest", _tracer(**counts))
    assert metric_reader(NAME)(None) is None


def test_reads_nothing_without_a_tracer(monkeypatch):
    from jsdr_tpu_torch.runtime import log

    monkeypatch.setattr(log, "_latest", None)
    assert metric_reader(NAME)(None) is None
    monkeypatch.delattr(log, "latest")
    assert metric_reader(NAME)(None) is None


def test_a_cpu_run_of_the_cells_stages_replays_nothing():
    """On the CPU the telemetry stage takes the eager step every block:
    the reader reads 0."""
    from jsdr_tpu_torch.runtime.executor import Session

    cfg = load_cell("fcd1-96k-tabs2.quiet").config
    n = cfg["chunk_samples"]
    raw = np.random.default_rng(18).integers(
        -3000, 3000, 2 * cfg["block_samples"] * 2, dtype=np.int16)
    chunks = [raw[i:i + 2 * n] for i in range(0, len(raw), 2 * n)]
    session = Session(source=iter(chunks),
                      block_samples=cfg["block_samples"], device="cpu",
                      timers=harness.SpanTimers())
    assert session.run(harness.build_stages(cfg, "cpu")) == 2
    assert session.tracer.counters["telemetry.graph_eager"] == 2
    assert metric_reader(NAME)(None) == 0.0
