"""``telemetry.step_ms``: the telemetry stage's step call (the enqueue of
its launches, the drain not counted), its ``telemetry.step`` span, host
wall ms a block, over the window's blocks outside the profiled ones that
the program's span ring holds. Layer: the telemetry step."""

from portbench.program_spans import per_block_ms


def read(run):
    return per_block_ms(run, lambda name: name == "telemetry.step")
