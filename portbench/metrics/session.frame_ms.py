"""``session.frame_ms``: the Session's wait for a block, its
``session.frame`` span (the source's chunks and the framer's pushes until
the block is whole), host wall ms a block, over the window's blocks
outside the profiled ones that the program's span ring holds. Layer: the
Session."""

from portbench.program_spans import per_block_ms


def read(run):
    return per_block_ms(run, lambda name: name == "session.frame")
