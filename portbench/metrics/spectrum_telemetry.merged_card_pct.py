"""``spectrum_telemetry.merged_card_pct``: the share of the run's blocks
whose spectrum-telemetry step ran the merged kernel 3 because the card's
rule admitted a block length that the reference's rule would stage (T a
multiple of one FFT block, not of the TPU kernel's chunk of 2 or 4), %:
the program's ``spectrum_telemetry.merged_card`` counter over its
``session.blocks``, read from the tracer of the latest ``Session.run``
(``runtime.log.latest()``). The stage counts it beside
``spectrum_telemetry.merged``; None where the program never counted it (a
program with the reference's rule alone stages every 0.1 s block and has
no such counter). Layer: the telemetry step."""

COUNTER = "spectrum_telemetry.merged_card"


def read(run):
    try:
        from jsdr_tpu_torch.runtime.log import latest
    except ImportError:
        return None
    counters = getattr(latest(), "counters", None) or {}
    blocks = counters.get("session.blocks", 0)
    if not blocks or COUNTER not in counters:
        return None
    return 100.0 * counters[COUNTER] / blocks
