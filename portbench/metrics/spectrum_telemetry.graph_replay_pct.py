"""``spectrum_telemetry.graph_replay_pct``: the share of the run's blocks
whose spectrum-telemetry step replayed a captured CUDA graph, %: the
program's ``telemetry.graph_replays`` counter over its ``session.blocks``,
read from the tracer of the latest ``Session.run``
(``runtime.log.latest()``). The stage counts each step once, as
``telemetry.graph_replays``, ``telemetry.graph_captures`` or
``telemetry.graph_eager``, beside ``spectrum_telemetry.merged`` or
``spectrum_telemetry.staged``; None where the program counts none of the
first three, or none of the last two (no spectrum-telemetry stage).
Layer: the telemetry step."""

STEP = ("telemetry.graph_replays", "telemetry.graph_captures",
        "telemetry.graph_eager")
STAGE = ("spectrum_telemetry.merged", "spectrum_telemetry.staged")


def read(run):
    try:
        from jsdr_tpu_torch.runtime.log import latest
    except ImportError:
        return None
    counters = getattr(latest(), "counters", None) or {}
    blocks = counters.get("session.blocks", 0)
    if (not blocks or not any(name in counters for name in STEP)
            or not any(name in counters for name in STAGE)):
        return None
    return 100.0 * counters.get("telemetry.graph_replays", 0) / blocks
