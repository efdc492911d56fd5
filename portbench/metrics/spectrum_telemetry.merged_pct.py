"""``spectrum_telemetry.merged_pct``: the share of the run's blocks whose
spectrum-telemetry step ran the merged kernel 3 (one read of the input for
the display spectrum and the tabs' front end), %: the program's
``spectrum_telemetry.merged`` counter over its ``session.blocks``, read
from the tracer of the latest ``Session.run`` (``runtime.log.latest()``).
The stage counts each step once, as ``spectrum_telemetry.merged`` or
``spectrum_telemetry.staged``; None where the program counts neither.
Layer: the telemetry step."""

STEP = ("spectrum_telemetry.merged", "spectrum_telemetry.staged")


def read(run):
    try:
        from jsdr_tpu_torch.runtime.log import latest
    except ImportError:
        return None
    counters = getattr(latest(), "counters", None) or {}
    blocks = counters.get("session.blocks", 0)
    if not blocks or not any(name in counters for name in STEP):
        return None
    return 100.0 * counters.get("spectrum_telemetry.merged", 0) / blocks
