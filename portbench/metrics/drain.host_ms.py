"""``drain.host_ms``: a telemetry drain's host wall, its whole
``telemetry.drain`` span (the readbacks that wait for the card, the FEC
kernels' enqueue, the publishes), ms, the mean over every drain of the
window's blocks outside the profiled ones that the program's span ring
holds, whether or not it decoded a frame. Layer: the FEC drain."""

from portbench.program_spans import window_spans


def read(run):
    blocks = window_spans(run)
    walls = [wall for spans in (blocks or {}).values()
             for name, _, wall in spans if name == "telemetry.drain"]
    return sum(walls) / len(walls) / 1e6 if walls else None
