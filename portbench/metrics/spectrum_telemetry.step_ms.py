"""``spectrum_telemetry.step_ms``: the spectrum-telemetry stage's step call
(the merged kernel 3 or the staged pair and the telemetry tail, eager; the
drain not counted), its ``spectrum_telemetry.step`` span, host wall ms a
block, over the window's blocks outside the profiled ones that the
program's span ring holds. None where those blocks hold no such span (a
program without it). Layer: the telemetry step."""

from portbench.program_spans import window_spans


def read(run):
    blocks = window_spans(run) or {}
    walls = [wall for spans in blocks.values() for name, _, wall in spans
             if name == "spectrum_telemetry.step"]
    if not walls:
        return None
    return sum(walls) / len(blocks) / 1e6
