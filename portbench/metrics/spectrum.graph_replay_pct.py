"""``spectrum.graph_replay_pct``: the share of the run's blocks whose
``SpectrumStage`` waterfall step replayed a captured CUDA graph, %: the
program's ``spectrum.graph_replays`` counter over its ``session.blocks``,
read from the tracer of the latest ``Session.run``
(``runtime.log.latest()``). The stage counts each block once, as
``spectrum.graph_replays``, ``spectrum.graph_captures`` or
``spectrum.graph_eager``; None where the program counts none of them.
Layer: the stages."""

STEP = ("spectrum.graph_replays", "spectrum.graph_captures",
        "spectrum.graph_eager")


def read(run):
    try:
        from jsdr_tpu_torch.runtime.log import latest
    except ImportError:
        return None
    counters = getattr(latest(), "counters", None) or {}
    blocks = counters.get("session.blocks", 0)
    if not blocks or not any(name in counters for name in STEP):
        return None
    return 100.0 * counters.get("spectrum.graph_replays", 0) / blocks
