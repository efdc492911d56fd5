"""Demodulators of the port (FUNcube BPSK telemetry, pattern tuning)."""
