"""The program's own spans, for the readers of ``program_span`` metrics.

The port's Session keeps a tracer (``jsdr_tpu_torch.runtime.log.
StageTimers``) whose spans are on through a ``Session.run`` that starts
while torch's profiler records, as a ``--trace 1`` run's does, and
registers it as the process's latest (``runtime.log.latest()``). A span is
``(name, block, parent, t0_ns, t1_ns)`` on ``perf_counter_ns``; the ring
keeps the newest 65,536. A program without that tracer, or a run with
spans off, gives nothing to read: the readers then return None.
"""

from __future__ import annotations


def window_spans(run) -> dict | None:
    """{block: [(name, parent, wall_ns)]} for the blocks from
    ``run.untraced_from`` to ``run.n_blocks - 1`` whose spans the ring
    still holds whole (a block's first span to close is its
    ``session.frame``), or None where there are none."""
    try:
        from jsdr_tpu_torch.runtime.log import latest
    except ImportError:
        return None
    tracer = latest()
    spans = tracer.spans() if tracer is not None else []
    held = {b for name, b, *_ in spans if name == "session.frame"}
    out = {b: [] for b in range(run.untraced_from, run.n_blocks)
           if b in held}
    for name, b, parent, t0, t1 in spans:
        if b in out:
            out[b].append((name, parent, t1 - t0))
    return out or None


def per_block_ms(run, match) -> float | None:
    """The walls of the spans whose name ``match`` accepts, summed over
    the blocks read and divided by their number, ms."""
    blocks = window_spans(run)
    if not blocks:
        return None
    ns = sum(wall for spans in blocks.values()
             for name, _, wall in spans if match(name))
    return ns / len(blocks) / 1e6
