"""The reader of ``session.h2d_pinned_pct`` (a ``program_counter`` metric
of the Session layer in every cell): the share of the run's blocks that
went up from a pinned framer block through the card's conversion kernel,
from the tracer of the latest ``Session.run``; None where the program
counts no ``session.h2d_pinned`` (a program before the pinned framer, a
CPU run, a run without a tracer)."""

import numpy as np
import pytest

from portbench import harness
from portbench.cells import load_cell, metric_reader

NAME = "session.h2d_pinned_pct"
CELLS = ["fcd1-96k-tabs2.quiet", "fcd2-192k-merged-tabs2.quiet",
         "fcd2-192k-offgrid-tabs2.quiet"]


def _tracer(**counts):
    from jsdr_tpu_torch.runtime.log import StageTimers

    tr = StageTimers()
    for name, n in counts.items():
        tr.count(name.replace("__", "."), n)
    return tr


@pytest.mark.parametrize("counts,want", [
    ({"session__blocks": 200, "session__h2d_pinned": 200}, 100.0),
    ({"session__blocks": 8, "session__h2d_pinned": 6}, 75.0),
])
def test_reads_the_share_of_pinned_blocks(monkeypatch, counts, want):
    from jsdr_tpu_torch.runtime import log

    monkeypatch.setattr(log, "_latest", _tracer(**counts))
    assert metric_reader(NAME)(None) == pytest.approx(want)


@pytest.mark.parametrize("counts", [
    {"session__blocks": 12, "session__framer_bytes": 12},
    {"session__h2d_pinned": 3},
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


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_lists_it_in_the_session_layer(cell):
    (m,) = [m for m in load_cell(cell).per_layer if m["name"] == NAME]
    assert (m["source"], m["layer"], m["moves"], m["unit"]) == (
        "program_counter", "Session", "stream_msps", "%")
    assert m["workloads"] == CELLS


def test_a_cpu_run_reads_nothing():
    """On the CPU the Session frames into numpy blocks and converts with
    the plain chain: it counts no ``session.h2d_pinned``."""
    from jsdr_tpu_torch.runtime.executor import Session

    cfg = load_cell(CELLS[0]).config
    n = cfg["chunk_samples"]
    raw = np.random.default_rng(24).integers(
        -3000, 3000, 2 * cfg["block_samples"] * 2, dtype=np.int16)
    chunks = [raw[i:i + 2 * n] for i in range(0, len(raw), 2 * n)]
    session = Session(source=iter(chunks),
                      block_samples=cfg["block_samples"], device="cpu",
                      timers=harness.SpanTimers())
    assert session.run([]) == 2
    assert session.tracer.counters["session.blocks"] == 2
    assert metric_reader(NAME)(None) is None
