"""``drain.wall_ms``: a telemetry drain's host wall, from its
'telemetry-counters' publish (the counters' readback done) to its last
'telemetry-frame' publish (kernels A and B, the readbacks of ok, rc and
payloads, the publishes), ms, the mean over the window's drains that
published a frame, outside the profiled blocks. Layer: the FEC drain."""


def read(run):
    first = run.untraced_from
    walls = [d.t_frames[-1] - d.t_counters for d in run.drains
             if d.block >= first and d.t_frames]
    return sum(walls) / len(walls) * 1e3 if walls else None
