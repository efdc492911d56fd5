"""``stages.wall_ms``: the host wall of all the cell's stages a block (the
Session's stage timers, every stage but "h2d"; a drain or a readback that
waits for the device falls inside its stage), ms, over the window's blocks
outside the profiled ones. Layer: the stages."""


def read(run):
    blocks = run.window_blocks(run.untraced_from)
    keep = set(blocks)
    wall = sum(t1 - t0 for name, b, t0, t1 in run.spans
               if name != "h2d" and b in keep)
    return wall / len(blocks) * 1e3 if len(blocks) else None
