"""Demodulators of the port: FUNcube BPSK telemetry in every tuning mode
(``bpsk``) and its FFT auto-tuner (``fft_tuner``), and AM/NFM/WFM audio
(``am_fm``)."""

from .am_fm import (AmFmConfig, AmFmState, Mode,  # noqa: F401
                    audio_to_s16_stereo, demod_block, state_from_numpy,
                    state_to_numpy)
