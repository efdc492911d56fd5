"""``session.listeners_ms``: the time the Session's bus listeners take,
every ``publish:<topic>`` span, host wall ms a block, over the window's
blocks outside the profiled ones that the program's span ring holds. In
the benchmark the listener is mostly its own recorder: this says how much
of ``stages.wall_ms`` and the block is not the program. Layer: the
Session."""

from portbench.program_spans import per_block_ms


def read(run):
    return per_block_ms(run, lambda name: name.startswith("publish:"))
