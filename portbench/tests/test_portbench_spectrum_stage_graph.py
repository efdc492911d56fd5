"""The reader of ``spectrum.graph_replay_pct`` (a ``program_counter``
metric of the 96 kS/s cell): the share of the run's blocks whose
``SpectrumStage`` waterfall step replayed a CUDA graph, from the tracer of
the latest ``Session.run``; None where the stage counts no step (a
program whose stage ran eagerly uncounted, or a run without a tracer). On
the CPU the cell's stage runs its step eagerly, and the reader reads 0."""

import numpy as np
import pytest

from portbench import harness
from portbench.cells import load_cell, metric_reader

NAME = "spectrum.graph_replay_pct"
CELL = "fcd1-96k-tabs2.quiet"


def _tracer(**counts):
    from jsdr_tpu_torch.runtime.log import StageTimers

    tr = StageTimers()
    for name, n in counts.items():
        tr.count(name.replace("__", "."), n)
    return tr


@pytest.mark.parametrize("counts,want", [
    ({"session__blocks": 400, "spectrum__graph_replays": 398,
      "spectrum__graph_captures": 1, "spectrum__graph_eager": 1,
      "telemetry__graph_replays": 395}, 99.5),
    ({"session__blocks": 8, "spectrum__graph_eager": 8}, 0.0),
])
def test_reads_the_share_of_replayed_blocks(monkeypatch, counts, want):
    from jsdr_tpu_torch.runtime import log

    monkeypatch.setattr(log, "_latest", _tracer(**counts))
    assert metric_reader(NAME)(None) == pytest.approx(want)


@pytest.mark.parametrize("counts", [
    {"session__blocks": 12, "telemetry__graph_replays": 12},
    {"spectrum__graph_replays": 3},
    {"session__blocks": 12, "drain__runs": 3},
])
def test_reads_nothing_without_the_counters(monkeypatch, counts):
    """No spectrum step counters (the telemetry step's do not count), or
    no blocks."""
    from jsdr_tpu_torch.runtime import log

    monkeypatch.setattr(log, "_latest", _tracer(**counts))
    assert metric_reader(NAME)(None) is None


def test_reads_nothing_without_a_tracer(monkeypatch):
    from jsdr_tpu_torch.runtime import log

    monkeypatch.setattr(log, "_latest", None)
    assert metric_reader(NAME)(None) is None
    monkeypatch.delattr(log, "latest")
    assert metric_reader(NAME)(None) is None


def test_the_cell_lists_it_in_the_stages_layer():
    c = load_cell(CELL)
    (m,) = [m for m in c.per_layer if m["name"] == NAME]
    assert (m["source"], m["layer"], m["moves"], m["unit"], m["better"]) == (
        "program_counter", "stages", "stream_msps", "%", "higher")
    assert m["workloads"] == [CELL]


def test_a_cpu_run_of_the_cells_stages_replays_nothing():
    """On the CPU the cell's ``SpectrumStage`` takes the eager step every
    block, counted once a block under ``spectrum.graph_*``; the
    telemetry step's counters count its own blocks alone."""
    from jsdr_tpu_torch.runtime.executor import Session

    cfg = load_cell(CELL).config
    n = cfg["chunk_samples"]
    raw = np.random.default_rng(22).integers(
        -3000, 3000, 2 * cfg["block_samples"] * 2, dtype=np.int16)
    chunks = [raw[i:i + 2 * n] for i in range(0, len(raw), 2 * n)]
    session = Session(source=iter(chunks),
                      block_samples=cfg["block_samples"], device="cpu",
                      timers=harness.SpanTimers())
    assert session.run(harness.build_stages(cfg, "cpu")) == 2
    c = session.tracer.counters
    assert c["spectrum.graph_eager"] == 2 and c["telemetry.graph_eager"] == 2
    assert metric_reader(NAME)(None) == 0.0
