"""``telemetry.general_front_pct``: the share of the run's blocks whose
telemetry step ran the general front end (the tuner's exact numerator
mix at full length, then the polyphase decimator), %: the program's
``telemetry.front.general`` counter over its ``session.blocks``, read
from the tracer of the latest ``Session.run`` (``runtime.log.latest()``).
The telemetry stages count each step once as ``telemetry.front.<mode>``;
None where the program counts no ``telemetry.front.*``. Layer: the
telemetry step."""

PREFIX = "telemetry.front."


def read(run):
    try:
        from jsdr_tpu_torch.runtime.log import latest
    except ImportError:
        return None
    counters = getattr(latest(), "counters", None) or {}
    blocks = counters.get("session.blocks", 0)
    if not blocks or not any(name.startswith(PREFIX) for name in counters):
        return None
    return 100.0 * counters.get(PREFIX + "general", 0) / blocks
