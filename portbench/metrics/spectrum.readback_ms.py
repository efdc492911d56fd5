"""``spectrum.readback_ms``: ``SpectrumStage``'s copy of its PSD and
lines (or PSD and peak) to the host, which waits for the card: its
``spectrum.readback`` span, host wall ms a block, over the window's
blocks outside the profiled ones that the program's span ring holds.
Layer: the stages."""

from portbench.program_spans import per_block_ms


def read(run):
    return per_block_ms(run, lambda name: name == "spectrum.readback")
