"""``session.framer_copy_mb``: the bytes the Session's framer copied to
make a block, MB (1e6 bytes): the program's ``session.framer_bytes``
counter over its ``session.blocks``, read from the tracer of the latest
``Session.run`` (``runtime.log.latest()``). A framer that copies each
sample once reads the raw block's bytes; None where the program has no
such counter. Layer: Session."""


def read(run):
    try:
        from jsdr_tpu_torch.runtime.log import latest
    except ImportError:
        return None
    counters = getattr(latest(), "counters", None) or {}
    blocks = counters.get("session.blocks", 0)
    if not blocks or "session.framer_bytes" not in counters:
        return None
    return counters["session.framer_bytes"] / blocks / 1e6
