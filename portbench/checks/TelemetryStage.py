"""Check of ``TelemetryStage``: the frames and counters of each checked
drain against the plain reference (``checklib.telemetry_numbers``)."""

from portbench.checklib import telemetry_numbers


def numbers(params, start, sampled, dev, control):
    return telemetry_numbers(params, start, sampled, dev, control)
