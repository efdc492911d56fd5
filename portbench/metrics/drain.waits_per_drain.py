"""``drain.waits_per_drain``: the host waits on the card a telemetry
drain makes, waits/drain: the program's ``drain.waits`` counter over its
``drain.runs``, read from the tracer of the latest ``Session.run``
(``runtime.log.latest()``); None where the program counts no
``drain.waits``. Layer: the FEC drain."""


def read(run):
    try:
        from jsdr_tpu_torch.runtime.log import latest
    except ImportError:
        return None
    counters = getattr(latest(), "counters", None) or {}
    runs = counters.get("drain.runs", 0)
    if not runs or "drain.waits" not in counters:
        return None
    return counters["drain.waits"] / runs
