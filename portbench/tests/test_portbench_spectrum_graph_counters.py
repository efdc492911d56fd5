"""The reader of ``spectrum_telemetry.graph_replay_pct`` (a
``program_counter`` metric of the 192 kS/s cell): the share of the run's
blocks whose spectrum-telemetry step replayed a CUDA graph, from the
tracer of the latest ``Session.run``; None where there are no step
counters or no spectrum-telemetry stage counted (a program whose stage
counts no step, or a run without a tracer). On the CPU the cell's stage
runs its step eagerly, and the reader reads 0, as it does for the commit
before the stage's graphs, whose stage counted every step eager."""

import numpy as np
import pytest

from portbench import harness
from portbench.cells import load_cell, metric_reader

NAME = "spectrum_telemetry.graph_replay_pct"
CELL = "fcd2-192k-merged-tabs2.quiet"


def _tracer(**counts):
    from jsdr_tpu_torch.runtime.log import StageTimers

    tr = StageTimers()
    for name, n in counts.items():
        tr.count(name.replace("__", "."), n)
    return tr


@pytest.mark.parametrize("counts,want", [
    ({"session__blocks": 200, "telemetry__graph_replays": 195,
      "telemetry__graph_captures": 4, "telemetry__graph_eager": 1,
      "spectrum_telemetry__merged": 200}, 97.5),
    ({"session__blocks": 8, "telemetry__graph_eager": 8,
      "spectrum_telemetry__staged": 8}, 0.0),
])
def test_reads_the_share_of_replayed_blocks(monkeypatch, counts, want):
    from jsdr_tpu_torch.runtime import log

    monkeypatch.setattr(log, "_latest", _tracer(**counts))
    assert metric_reader(NAME)(None) == pytest.approx(want)


@pytest.mark.parametrize("counts", [
    {"session__blocks": 12, "spectrum_telemetry__merged": 12},
    {"session__blocks": 12, "telemetry__graph_replays": 12},
    {"telemetry__graph_replays": 3, "spectrum_telemetry__merged": 3},
    {"session__blocks": 12, "drain__runs": 3},
])
def test_reads_nothing_without_the_counters(monkeypatch, counts):
    """No step counters, no spectrum-telemetry stage (a ``TelemetryStage``
    alone counts the step counters too), or no blocks."""
    from jsdr_tpu_torch.runtime import log

    monkeypatch.setattr(log, "_latest", _tracer(**counts))
    assert metric_reader(NAME)(None) is None


def test_reads_nothing_without_a_tracer(monkeypatch):
    from jsdr_tpu_torch.runtime import log

    monkeypatch.setattr(log, "_latest", None)
    assert metric_reader(NAME)(None) is None
    monkeypatch.delattr(log, "latest")
    assert metric_reader(NAME)(None) is None


def test_the_cell_lists_it_in_the_telemetry_step_layer():
    c = load_cell(CELL)
    (m,) = [m for m in c.per_layer if m["name"] == NAME]
    assert (m["source"], m["layer"], m["moves"], m["unit"]) == (
        "program_counter", "telemetry step", "stream_msps", "%")
    assert m["workloads"] == [CELL]


def test_a_cpu_run_of_the_cells_stage_replays_nothing():
    """On the CPU the cell's ``SpectrumTelemetryStage`` takes the eager
    step every block: the reader reads 0."""
    from jsdr_tpu_torch.runtime.executor import Session

    cfg = load_cell(CELL).config
    n = cfg["chunk_samples"]
    raw = np.random.default_rng(20).integers(
        -3000, 3000, 2 * cfg["block_samples"] * 2, dtype=np.int16)
    chunks = [raw[i:i + 2 * n] for i in range(0, len(raw), 2 * n)]
    session = Session(source=iter(chunks),
                      block_samples=cfg["block_samples"], device="cpu",
                      timers=harness.SpanTimers())
    assert session.run(harness.build_stages(cfg, "cpu")) == 2
    c = session.tracer.counters
    assert c["telemetry.graph_eager"] == 2
    assert c["spectrum_telemetry.merged"] == 2
    assert metric_reader(NAME)(None) == 0.0
