"""The readers of the program's spans (``metrics/<name>.py`` with source
``program_span``) on a small CPU run of the quiet cell's stages in the
port's Session: under torch's profiler, as in a ``--trace 1`` run, the
program's spans are on and each reader returns a positive number over
the blocks after the first; with spans off, and with a program that has
no tracer (the commit before it), each returns None."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.cells import load_cell, metric_reader

READERS = ("session.frame_ms", "session.listeners_ms",
           "spectrum.readback_ms", "telemetry.step_ms", "drain.host_ms")
BLOCKS = 9


def _run(profiled: bool) -> harness.RunRecord:
    from torch.profiler import ProfilerActivity, profile

    from jsdr_tpu_torch.runtime.executor import Session

    cell = load_cell("fcd1-96k-tabs2.quiet")
    cfg = cell.config
    n = cfg["chunk_samples"]
    raw = np.random.default_rng(7).integers(
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


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_programs_spans(profiled, name):
    value = metric_reader(name)(profiled)
    assert value is not None and value > 0, name


def test_readers_read_nothing_with_spans_off():
    run = _run(False)
    assert all(metric_reader(name)(run) is None for name in READERS)


def test_readers_read_nothing_from_a_program_without_the_tracer(
        profiled, monkeypatch):
    from jsdr_tpu_torch.runtime import log

    monkeypatch.delattr(log, "latest")
    assert all(metric_reader(name)(profiled) is None for name in READERS)


def test_the_benchmarks_own_spans_keep_their_meaning(profiled):
    """The benchmark's timers still get "h2d" then each stage, once a
    block: ``session.h2d_host_ms`` and ``stages.wall_ms`` read as before."""
    names = [name for name, *_ in profiled.spans]
    assert names == ["h2d", "spectrum", "telemetry"] * BLOCKS
    assert [b for _, b, *_ in profiled.spans] == [
        b for b in range(BLOCKS) for _ in range(3)]
    assert torch.autograd._profiler_enabled() is False
