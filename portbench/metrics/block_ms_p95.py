"""``block_ms_p95``: the 95th percentile, over the window's blocks
outside the profiled ones, of the time from the hand-in of a block's last
chunk to the Session's 'audio-frame' tick for it (published once every
stage has processed the block; a block that carries a drain or a
readback waits for it), ms. The worst blocks decide whether a live stream
keeps up. Layer: the Session."""

from portbench.harness import block_latencies, p95


def read(run):
    lat = block_latencies(run, run.untraced_from)
    return p95(lat)
