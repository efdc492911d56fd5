"""``session.h2d_pinned_pct``: the share of the run's blocks that the
Session framed straight into pinned host memory, uploaded from there and
converted with the card's conversion kernel, %: the program's
``session.h2d_pinned`` counter over its ``session.blocks``, read from the
tracer of the latest ``Session.run`` (``runtime.log.latest()``); None
where the program counts no ``session.h2d_pinned``. Layer: Session."""


def read(run):
    try:
        from jsdr_tpu_torch.runtime.log import latest
    except ImportError:
        return None
    counters = getattr(latest(), "counters", None) or {}
    blocks = counters.get("session.blocks", 0)
    if not blocks or "session.h2d_pinned" not in counters:
        return None
    return 100.0 * counters["session.h2d_pinned"] / blocks
