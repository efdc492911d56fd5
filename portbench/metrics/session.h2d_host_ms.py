"""``session.h2d_host_ms``: the Session's upload and conversion of a block
("h2d" in its stage timers: the raw fan-out, the pinned upload and the
device conversion's enqueue), host wall ms a block, over the window's
blocks outside the profiled ones. Layer: the Session."""


def read(run):
    blocks = run.window_blocks(run.untraced_from)
    keep = set(blocks)
    wall = sum(t1 - t0 for name, b, t0, t1 in run.spans
               if name == "h2d" and b in keep)
    return wall / len(blocks) * 1e3 if len(blocks) else None
