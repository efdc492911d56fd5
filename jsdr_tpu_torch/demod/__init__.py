"""Demodulators of the port: FUNcube BPSK telemetry in every tuning mode
(``bpsk``) and its FFT auto-tuner (``fft_tuner``)."""
