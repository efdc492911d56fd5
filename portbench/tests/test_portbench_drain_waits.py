"""The reader of ``drain.waits_per_drain`` (a ``program_counter`` metric
of the FEC drain layer in the 96 kS/s cell): the host waits on the card a
telemetry drain made, ``drain.waits`` over ``drain.runs``, from the
tracer of the latest ``Session.run``; None where the program counts no
``drain.waits`` (a program before the drain read back in one copy, a run
without a drain or without a tracer)."""

import numpy as np
import pytest

from portbench import harness
from portbench.cells import load_cell, metric_reader

NAME = "drain.waits_per_drain"
CELLS = ["fcd1-96k-tabs2.quiet"]


def _tracer(**counts):
    from jsdr_tpu_torch.runtime.log import StageTimers

    tr = StageTimers()
    for name, n in counts.items():
        tr.count(name.replace("__", "."), n)
    return tr


@pytest.mark.parametrize("counts,want", [
    ({"drain__runs": 50, "drain__waits": 50}, 1.0),
    ({"drain__runs": 4, "drain__waits": 7, "drain__hits": 3}, 1.75),
])
def test_reads_the_waits_of_a_drain(monkeypatch, counts, want):
    from jsdr_tpu_torch.runtime import log

    monkeypatch.setattr(log, "_latest", _tracer(**counts))
    assert metric_reader(NAME)(None) == pytest.approx(want)


@pytest.mark.parametrize("counts", [
    {"session__blocks": 12, "drain__runs": 3},      # a program without it
    {"drain__waits": 3},                            # no drain
    {"session__blocks": 12},
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
def test_the_cell_lists_it_in_the_drain_layer(cell):
    (m,) = [m for m in load_cell(cell).per_layer if m["name"] == NAME]
    assert (m["source"], m["layer"], m["moves"], m["unit"], m["better"]) == (
        "program_counter", "FEC drain", "stream_msps", "waits/drain", "lower")
    assert m["workloads"] == CELLS


def test_a_cpu_run_of_the_cells_stages_reads_one_or_two():
    """The cell's stages on the CPU over 5 noise blocks: a full drain and
    ``finish()``'s last, each one wait and one more where it decoded."""
    from jsdr_tpu_torch.runtime.executor import Session

    cfg = load_cell(CELLS[0]).config
    n = cfg["chunk_samples"]
    raw = np.random.default_rng(26).integers(
        -3000, 3000, 2 * cfg["block_samples"] * 5, dtype=np.int16)
    chunks = [raw[i:i + 2 * n] for i in range(0, len(raw), 2 * n)]
    session = Session(source=iter(chunks),
                      block_samples=cfg["block_samples"], device="cpu",
                      timers=harness.SpanTimers())
    assert session.run(harness.build_stages(cfg, "cpu")) == 5
    c = session.tracer.counters
    assert c["drain.runs"] == 2
    assert 1.0 <= metric_reader(NAME)(None) <= 2.0
    assert metric_reader(NAME)(None) == pytest.approx(c["drain.waits"] / 2)
